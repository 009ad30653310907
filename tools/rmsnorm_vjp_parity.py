"""Count the elements where the port's RMSNorm gradients part from
``jax.vjp`` of the JAX package's ``rmsnorm``, for the port's custom VJP
and for the form it replaced (autograd through the forward, the f32
upcast included).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rmsnorm_vjp_parity.py

Inputs: x (4, 64, 256) drawn from numpy's ``default_rng(0)`` and scaled
by 3, then the scale (256,) scaled by 0.1, then the cotangent, each
rounded to the dtype under test.  Prints, per dtype and form, the
differing elements of out, gx and gscale, and the largest difference
relative to the largest magnitude.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro.models.layers import rmsnorm as j_rmsnorm  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402


def autograd_rmsnorm(x, scale, eps: float = 1e-6):
    """The earlier form: the forward alone, differentiated by autograd."""
    dt = x.dtype
    x32 = x.float()
    var = torch.einsum("...d,...d->...", x32, x32)[..., None] / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(dt)
    return (x * inv) * (1.0 + scale.to(dt))


def main() -> None:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64, 256)) * 3
    scale = rng.normal(size=(256,)) * 0.1
    g = rng.normal(size=(4, 64, 256))
    for dtype in ("float32", "bfloat16"):
        jx, js, jg = (jnp.asarray(a, dtype) for a in (x, scale, g))
        jout, vjp = jax.vjp(j_rmsnorm, jx, js)
        want = (jout,) + vjp(jg)

        def torch_of(a):
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
                getattr(torch, dtype))
        for label, fn in (("custom VJP", rmsnorm),
                          ("autograd through the forward",
                           autograd_rmsnorm)):
            tx = torch_of(jx).requires_grad_()
            ts = torch_of(js).requires_grad_()
            out = fn(tx, ts)
            out.backward(torch_of(jg))
            parts = []
            for name, a, b in zip(("out", "gx", "gscale"), want,
                                  (out, tx.grad, ts.grad)):
                a = np.asarray(a.astype(jnp.float32))
                b = b.detach().float().numpy()
                parts.append(f"{name} {int((a != b).sum())} of {a.size} "
                             f"(max {np.abs(a - b).max() / np.abs(a).max():.2e}"
                             f" of max|{name}|)")
            print(f"{dtype} {label}: " + ", ".join(parts))


if __name__ == "__main__":
    main()
