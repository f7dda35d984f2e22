"""The JAX package's ``default`` precision as its one-pass bf16 datapath, on the CPU.

The JAX package threads ``precision=get_precision()`` through its
contractions.  On the TPU, ``lax.Precision.DEFAULT`` is the MXU's one bf16
pass: each operand rounded to bf16, the products summed in float32.
XLA's CPU backend runs the same call in float32, so on the CPU the JAX
package's preview precision changes nothing but the activation storage.

:func:`one_pass_bf16` patches the three contractions the JAX package
issues at its policy's precision (``lax.conv_general_dilated``,
``jnp.matmul``, ``jnp.einsum``): a call at ``DEFAULT`` rounds its float32
operands to bf16 and runs at ``HIGHEST``; any other call runs unchanged.
The JAX package reads these functions when it traces, so enter the patch
after ``jax.clear_caches()`` and clear the caches again on leaving it.
"""

import contextlib

import jax
import jax.numpy as jnp
from jax import lax


def _round(a):
    a = jnp.asarray(a)
    return a.astype(jnp.bfloat16).astype(jnp.float32) if a.dtype == jnp.float32 else a


def _one_pass(fn, first: int, last):
    """``fn`` with operands ``args[first:last]`` rounded under DEFAULT."""
    def wrapped(*args, precision=None, **kw):
        if precision == lax.Precision.DEFAULT:
            ops = tuple(_round(a) for a in args[first:last])
            args = args[:first] + ops + (args[last:] if last is not None else ())
            precision = lax.Precision.HIGHEST
        return fn(*args, precision=precision, **kw)
    return wrapped


@contextlib.contextmanager
def one_pass_bf16():
    """The JAX package's ``default``-precision contractions on bf16-rounded
    operands with float32 sums, as the TPU runs them."""
    patched = [(lax, "conv_general_dilated", 0, 2), (jnp, "matmul", 0, 2),
               (jnp, "einsum", 1, None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in patched]
    jax.clear_caches()
    try:
        for mod, name, first, last in patched:
            setattr(mod, name, _one_pass(getattr(mod, name), first, last))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        jax.clear_caches()
