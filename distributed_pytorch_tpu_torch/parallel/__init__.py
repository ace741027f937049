"""Parallel training: the process world and its 'data', 'seq' and 'model'
axes (mesh.py), its ambient publication and collectives (context.py), the
recipes that decide what each rank holds whole and what it holds 1/W of
(sharding.py), and the tensor-parallel cut (tensor.py)."""
