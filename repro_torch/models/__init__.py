"""Models: layers, attention, block stacks and the LM (``attn_mlp`` blocks)."""
