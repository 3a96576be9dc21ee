"""Complex-free host<->device boundaries.

These helpers pack complex leaves as float32 [2, ...] arrays at jit
boundaries so every executable is complex-free at its edges: complex
intermediates and state stay on the device, and what crosses to or from
the host is two dense float planes.

Usage:
    packed_state = tree_pack(state)            # host side, once
    new_packed, out = jitted_step(packed_state, x_pair, ...)
    # inside the jitted step:
    state = tree_unpack(packed_state)
    ...
    return tree_pack(new_state), out
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_TAG = "__c64__"


def pack_c64(z):
    """complex [...]  -> float32 [2, ...] (works in or out of jit)."""
    return jnp.stack([jnp.real(z), jnp.imag(z)]).astype(jnp.float32)


def unpack_c64(f):
    """float32 [2, ...] -> complex64 [...]."""
    return (f[0] + 1j * f[1]).astype(jnp.complex64)


def _is_complex(x) -> bool:
    return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.complexfloating)


def tree_pack(tree):
    """Replace every complex leaf with {"__c64__": float32 [2, ...]}."""
    return jax.tree_util.tree_map(
        lambda x: {_TAG: pack_c64(x)} if _is_complex(x) else x, tree)


def tree_unpack(tree):
    """Inverse of tree_pack."""
    def walk(node):
        if isinstance(node, dict):
            if set(node.keys()) == {_TAG}:
                return unpack_c64(node[_TAG])
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(tree)
