"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and there
    is none — entry points never carry on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


#: The device of the dry-run's shape-only tensors (``launch/dryrun.py``):
#: meta tensors hold shapes and dtypes and no memory.  Not fake ``cuda``
#: tensors: a torch built without CUDA aborts the process when autograd
#: meets one, and the dry-run runs on such machines too; and plain meta
#: tensors trace faster than ``FakeTensorMode``'s Python dispatch.  The
#: kernel wrappers route shape-only tensors (meta, or fake on any device
#: but the CPU) as they route CUDA tensors, to the kernels' shape-only
#: stand-ins, so the traced step is the step the card runs.
TRACE_DEVICE = torch.device("meta")


def is_shape_only(t) -> bool:
    """True for a tensor that has a shape and no data: a fake tensor
    (``FakeTensorMode``) or a meta tensor."""
    return t.device.type == "meta" or is_fake(t)
