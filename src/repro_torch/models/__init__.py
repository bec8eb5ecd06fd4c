"""The LM decoder (dense family): layers, model, serving steps."""
