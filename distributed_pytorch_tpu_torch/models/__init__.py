"""Model layers of the port: MLP, GQA attention, the LLM, generation."""
