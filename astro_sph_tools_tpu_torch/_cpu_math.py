"""The CPU math library's first calls, made once on one thread.

PyTorch's CPU build sends ``sqrt``, ``exp``, ``log`` and the other unary
functions below to Intel MKL's vector math library. On the first call of
such a function split over the intra-op threads (tensors past torch's
32,768-element grain), one or more threads' chunks came back wrong by
1e-4 to 3e-4 relative, an error the size of the library's
low-accuracy mode: in 19 of 64 fresh processes on one CPU host, through
this package's plain deposit (~3,500 particles into a 48^2 map). Every
later call of the same function was exact. The same functions called once
first on small tensors, which stay on the calling thread, left 0 of 48
fresh processes wrong. :func:`warm_cpu_math` makes those first calls; the
package runs it when it is imported.
"""

from __future__ import annotations

import torch

_OPS = (
    torch.sqrt, torch.rsqrt, torch.exp, torch.exp2, torch.expm1, torch.log, torch.log2,
    torch.log10, torch.log1p, torch.sin, torch.cos, torch.tan, torch.tanh, torch.asin,
    torch.acos, torch.atan, torch.erf, torch.erfc, torch.erfinv, torch.floor, torch.ceil,
    torch.trunc, torch.round, torch.reciprocal,
)


def warm_cpu_math() -> None:
    """Call each function once in f32 and f64 on 1,024 elements (under the
    grain, so on this thread alone); the results are discarded."""
    for dtype in (torch.float32, torch.float64):
        t = torch.linspace(0.1, 0.9, 1024, dtype=dtype)
        for op in _OPS:
            op(t)
