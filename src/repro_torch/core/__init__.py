"""Host layer, model forward, layer-wise inference and serving."""
