"""The LM decoder families: layers, MoE and SSM blocks, model, serving
and training steps."""
