"""Launch, routing and timing helpers of the probe modules."""

from __future__ import annotations

import numpy as np
import torch


def route(name, plain_calls, *tensors) -> bool:
    """True: launch the kernel (every tensor on the card). False: run the
    plain version (every tensor on the CPU; counted in `plain_calls`)."""
    devs = {t.device.type for t in tensors}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        plain_calls[name] += 1
        return False
    raise ValueError(f"{name}: tensors on devices {sorted(devs)}; expected "
                     "all on cuda or all on cpu")


def launch(entry: str, iparams, *tensors):
    """Call the C entry point `entry` of csrc/probes.cu on the current
    stream: (int parameters, device pointers..., stream)."""
    from ..ops import _build

    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{entry}: non-contiguous tensor "
                             f"{tuple(t.shape)}")
    fn = _build.entry(entry, len(tensors) + 2, source="probes.cu")
    ip = np.ascontiguousarray(iparams, np.int32)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = fn(ip.ctypes.data, *[t.data_ptr() for t in tensors], stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed: "
                           f"{_build.error_string(err, 'probes.cu')} ({err})")


def time_ms(fn, reps: int = 10, warm: int = 1) -> float:
    """Device time per call: CUDA events around `reps` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time kernels on a CUDA card; none "
                           "is available")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
