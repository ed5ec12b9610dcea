"""The float32 precision a computation runs in on the card: TF32 off for
the reference, on for its control (the precision below the
configuration's float32)."""

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
