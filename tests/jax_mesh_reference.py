"""The JAX package's mesh as the reference of the port's mesh tests.

``platanus3_tpu.parallel.sharded.sharded_stage1`` calls its ``shard_map``
outside ``jax.jit``, so on the CPU it runs op by op: about a minute a
call even for a few kilobases.  ``jit_sharded_stage1`` makes the JAX
pipeline call it through ``jax.jit`` instead, which computes the same
function (the outputs are array-equal) in a few seconds.
"""

import jax

from platanus3_tpu.parallel import sharded as JS


def jit_sharded_stage1(monkeypatch) -> None:
    eager = JS.sharded_stage1

    def jitted(mesh, *args, **kw):
        return jax.jit(lambda: eager(mesh, *args, **kw))()

    monkeypatch.setattr(JS, "sharded_stage1", jitted)


def make_mesh(n: int = 4):
    """A mesh over ``n`` of the CPU devices ``tests/conftest.py`` makes."""
    return JS.make_mesh(jax.devices()[:n])
