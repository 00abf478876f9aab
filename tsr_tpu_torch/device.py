"""Device and dtype resolution for the port's entry points, and the
asynchronous host <-> device copies of its tree walks."""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` as a ``torch.device``.

    Raises when CUDA is asked for and absent: the port never moves work to
    the CPU on its own.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        # tensors report "cuda:N"; a bare "cuda" would compare unequal
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def compute_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` from a dtype or a name (``"bf16"``, ``"fp32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {dtype!r}") from None


class Transfers:
    """Asynchronous host <-> device copies for the pipelined tree walks.

    On CUDA, :meth:`up` stages host arrays in pinned memory and copies them
    with ``non_blocking=True`` on a dedicated copy stream, recording an
    event; the consuming thread calls :meth:`arrive`, which makes its
    current stream wait on that event and tells the caching allocator the
    tensors are used there (``record_stream``), so their memory is not
    reused early. :meth:`down` copies device results into pinned host
    tensors on a second stream, after the current stream's work, and
    records an event that :meth:`wait` blocks on. Pinned blocks are held by
    PyTorch's host allocator until their copy is done. On the CPU every
    method is a pass-through and the events are ``None``.
    """

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self._up = torch.cuda.Stream(device) if cuda else None
        self._down = torch.cuda.Stream(device) if cuda else None

    def up(self, *arrays):
        """Host arrays -> ``(device tensors, event)``."""
        hosts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self._up is None:
            return hosts, None
        with torch.cuda.stream(self._up):
            outs = [h.pin_memory().to(self.device, non_blocking=True)
                    for h in hosts]
            event = torch.cuda.Event()
            event.record(self._up)
        return outs, event

    def arrive(self, tensors, event) -> None:
        """Order the current stream after the upload of ``tensors``."""
        if event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)

    def down(self, *tensors):
        """Device tensors -> ``(host tensors, event)``, the copies queued
        after the current stream's work."""
        if self._down is None:
            return list(tensors), None
        self._down.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._down):
            hosts = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(self._down)
                hosts.append(h)
            event = torch.cuda.Event()
            event.record(self._down)
        return hosts, event

    @staticmethod
    def wait(event) -> None:
        """Block until the copies behind ``event`` are done."""
        if event is not None:
            event.synchronize()


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``.

    Host data (numpy, CPU tensors) is uploaded to ``device``; a tensor that
    already lives on another accelerator is refused rather than silently
    moved.
    """
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # torch.from_numpy needs a writable buffer
            x = x.copy()
        return torch.from_numpy(x).to(device)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a numpy array or tensor, got {type(x)}")
    if x.device.type != "cpu" and x.device != device:
        raise ValueError(f"tensor on {x.device}, expected {device}")
    return x.to(device)
