"""Data-parallel training: the process world (mesh.py), its ambient
publication (context.py) and the recipes that decide what each rank holds
whole and what it holds 1/W of (sharding.py)."""
