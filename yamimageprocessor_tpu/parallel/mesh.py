"""Device mesh execution: frame-parallel and spatially-sharded pipelines.

The reference has zero distributed machinery (SURVEY §2.5); its scaling
story is spatial tiling on one host.  The device-mesh equivalents:

* **Frame parallelism** (the batch-folder / 64-frame bench path):
  the fused chain is vmapped and the leading frame axis is sharded over the
  mesh with ``NamedSharding`` — XLA runs every chip on its own frames, no
  collectives.  Always bit-exact.

* **Spatial sharding** (gigapixel single frames): the frame's row axis is
  split across the mesh with ``shard_map``; each step exchanges HALO rows
  with its mesh neighbors via ``jax.lax.ppermute`` before its stencil, and
  global-statistics steps (Otsu, histogram equalization, min-max normalize)
  use their collective variants (``OpImpl.sharded_device_fn``: psum'd
  histograms / pmin / pmax), so thresholds are identical on every shard.
  Interior results are bit-identical to the dense path; at the outer image
  border the first/last shard applies the op's own border mode, and halo
  regions received from neighbors carry real pixels.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard"):
    """1-D mesh over the first ``n_devices`` devices."""

    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


# ---------------------------------------------------------------------------
# frame parallelism
def batch_sharded_apply(steps: Sequence[Any], images: np.ndarray, mesh) -> np.ndarray:
    """Apply the fused chain to a frame batch sharded over ``mesh``."""

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    chain = get_compiled_chain(
        list(steps), images.shape, images.dtype, batch=images.shape[0]
    )
    sharding = NamedSharding(mesh, P(axis))
    device_images = jax.device_put(jnp.asarray(images), sharding)
    return np.asarray(chain.run(device_images, list(steps))[-1])


# ---------------------------------------------------------------------------
# spatial sharding with halo exchange (ppermute pairs shared with the
# sharded-op collectives)
from yamimageprocessor_tpu.parallel.collectives import (
    neighbor_perms as _neighbor_perms,
)


def spatial_sharded_apply(
    steps: Sequence[Any],
    image: np.ndarray,
    mesh,
    *,
    jit_compile: bool = True,
) -> np.ndarray:
    """Run ``steps`` over a single frame row-sharded across ``mesh``.

    Every enabled step must be device-capable; global-stats steps must
    provide ``sharded_device_fn``.  The frame height must divide evenly by
    the mesh size (pad upstream if needed).
    """

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    n = mesh.devices.size
    h = image.shape[0]
    if h % n:
        raise ValueError(f"frame height {h} must divide by mesh size {n}")

    enabled = [s for s in steps if getattr(s, "enabled", True)]
    plans: List[Tuple[Any, dict, dict, int]] = []
    item_shape = (h // n,) + tuple(image.shape[1:])
    for step in enabled:
        impl = step.impl
        if impl is None or impl.device_fn is None:
            raise ValueError(f"step '{step.name}' is not device-capable")
        if impl.global_stats and impl.sharded_device_fn is None:
            raise ValueError(
                f"step '{step.name}' needs global statistics but has no "
                "sharded variant"
            )
        static, dyn = impl.split_params(step.params, image.shape)
        halo = 0 if impl.global_stats else impl.halo_for(step.params)
        if halo > h // n - 1 and impl.sharded_device_fn is None:
            # block[:halo] / the mirror slices silently yield fewer rows
            # than halo past this bound — reject loudly instead
            raise ValueError(
                f"step '{step.name}' needs a {halo}-row halo but shards are "
                f"only {h // n} rows tall; use fewer devices or a larger frame"
            )
        plans.append((impl, static, dyn, halo))

    down_perm, up_perm = _neighbor_perms(n)

    def exchange_halo(block, halo: int, mode: str):
        """Fetch ``halo`` rows from both mesh neighbors; TRUE frame edges
        are filled with the op's own border mode (``OpImpl.border_mode``)
        so sharded borders match the dense path bit-for-bit."""

        idx = jax.lax.axis_index(axis)
        top_rows = block[:halo]
        bottom_rows = block[-halo:]
        from_above = jax.lax.ppermute(bottom_rows, axis, down_perm)
        from_below = jax.lax.ppermute(top_rows, axis, up_perm)
        if mode == "edge":  # replicate
            fill_top = jnp.repeat(block[:1], halo, axis=0)
            fill_bottom = jnp.repeat(block[-1:], halo, axis=0)
        elif mode == "symmetric":  # reflect incl. the edge row
            fill_top = block[:halo][::-1]
            fill_bottom = block[-halo:][::-1]
        else:  # "reflect" = cv2 BORDER_REFLECT_101
            fill_top = block[1 : halo + 1][::-1]
            fill_bottom = block[-halo - 1 : -1][::-1]
        from_above = jnp.where(idx == 0, fill_top, from_above)
        from_below = jnp.where(idx == n - 1, fill_bottom, from_below)
        return jnp.concatenate([from_above, block, from_below], axis=0)

    def block_fn(block):
        cur = block
        for impl, static, dyn, halo in plans:
            dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
            if impl.sharded_device_fn is not None:
                # op-specific collective variant: exact everywhere, incl.
                # true frame edges (op-correct border fills / psum'd stats)
                cur = impl.sharded_device_fn(cur, dyn_j, axis=axis, **static)
            elif halo > 0:
                padded = exchange_halo(cur, halo, impl.border_mode)
                out = impl.device_fn(padded, dyn_j, **static)
                cur = out[halo:-halo]
            else:
                cur = impl.device_fn(cur, dyn_j, **static)
        return cur

    fn = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        check_vma=False,
    )
    if jit_compile:
        fn = jax.jit(fn)
    sharding = NamedSharding(mesh, P(axis))
    device_image = jax.device_put(jnp.asarray(image), sharding)
    return np.asarray(fn(device_image))


__all__ = ["make_mesh", "batch_sharded_apply", "spatial_sharded_apply"]
