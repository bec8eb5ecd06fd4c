from repro_torch.data.synth import (  # noqa: F401
    PRESETS, make_preset, make_sbm_graph, token_batches)
