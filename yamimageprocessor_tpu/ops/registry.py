"""Op implementation registry: device (jnp) + golden (numpy) twins.

Every op family from the reference inventory (SURVEY §2.2) registers an
:class:`OpImpl` binding its :class:`~yamimageprocessor_tpu.ops.schema.OpSchema`
to two callables:

* ``device_fn(img, dyn, **static)`` — pure, jittable jax function.  ``dyn``
  is a dict of traced inputs (host-precomputed LUTs / filter taps / scalar
  params) so parameter tweaks do NOT retrigger XLA compilation; only
  *structural* params (kernel sizes, channel selections, crop geometry)
  are baked into the compiled program.
* ``golden_fn(img, **params)`` — the framework's CPU reference path in pure
  numpy/scipy.  Tests assert device==golden (bit-exact for every
  mask/integer op) and golden≈cv2 (behavioral parity with the reference
  kernels in ``core/preprocessing.py`` / ``core/segmentation.py``).

``split(params)`` partitions raw op params into (static kwargs, dyn host
arrays).  ``halo(params)`` reports the stencil radius the tile runtime must
exchange between shards (the reference's tiling ignores halos and is wrong
at tile borders — SURVEY §5; we do it correctly).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from yamimageprocessor_tpu.ops.schema import OpSchema, Stage, op_by_identifier

# (static kwargs, dynamic host values to be device_put)
SplitResult = Tuple[Dict[str, Any], Dict[str, Any]]


def _default_split(params: Mapping[str, Any]) -> SplitResult:
    return dict(params), {}


@dataclass
class OpImpl:
    """Executable implementation bound to an op schema."""

    schema: OpSchema
    golden_fn: Callable[..., np.ndarray]
    device_fn: Optional[Callable[..., Any]] = None
    #: partition params -> (static kwargs, dynamic host arrays/scalars)
    split: Callable[[Mapping[str, Any]], SplitResult] = field(default=_default_split)
    #: stencil radius given params (for halo exchange); int or fn(params)->int
    halo: Any = 0
    #: pad mode the op's own borders use (numpy names: "reflect" =
    #: cv2 BORDER_REFLECT_101, "edge" = replicate, "symmetric" = reflect).
    #: The mesh halo exchange fills TRUE frame edges with this mode so
    #: sharded borders match the dense path bit-for-bit.
    border_mode: str = "reflect"
    #: False → op runs on host via golden_fn (reference slow-path ops)
    jittable: bool = True
    #: op output shape differs from input (crop) — breaks tile streaming
    reshapes: bool = False
    #: op needs the full frame (global statistics / labeling); tile runtime
    #: must gather or use collectives rather than run per-tile independently
    global_stats: bool = False
    #: mesh-aware variant: fn(img_block, dyn, axis=<mesh axis>, **static)
    #: computing its global statistics with collectives (psum/pmin/pmax)
    #: over spatially sharded blocks
    sharded_device_fn: Optional[Callable[..., Any]] = None
    #: streaming decomposition of a global-statistics op, so gigapixel
    #: chains never materialize (the reference streams EVERY chain,
    #: ``processing/pipeline_cache.py:416-574``): a stats pass accumulates
    #: ``tile_stats_fn(tile, dyn, **static)`` contributions with
    #: ``merge_stats_fn(acc, new)``, then an apply pass runs
    #: ``apply_stats_fn(tile, stats, dyn, **static)`` pointwise per tile.
    #: Functions may additionally accept ``box=`` / ``frame_shape=`` kwargs
    #: (grid-positional stats such as CLAHE).
    tile_stats_fn: Optional[Callable[..., Any]] = None
    merge_stats_fn: Optional[Callable[..., Any]] = None
    apply_stats_fn: Optional[Callable[..., Any]] = None
    #: optional predicate ``fn(static_params, frame_shape) -> bool`` gating
    #: the streaming decomposition on geometry (e.g. CLAHE needs the grid
    #: padding to stay inside the last cell); None = always streamable
    stream_gate: Optional[Callable[..., bool]] = None
    #: LUT expressibility: ops whose uint8 action is exactly ``lut[img]``
    #: for a 256-entry table expose ``lut_fn(img, dyn, **static) -> (256,)
    #: uint8`` (traced).  The chain compiler composes maximal runs of such
    #: steps into ONE table application (``compose(L2, L1)[x] == L2[L1[x]]``
    #: — exact, no float re-rounding), collapsing several full-frame HBM
    #: passes into one.  ``lut_needs_image`` marks stats-derived tables
    #: (histogram equalization) — those may only OPEN a run, value-only
    #: tables (gamma, brightness/contrast) may extend it.  ``lut_ndims``
    #: restricts applicability (hist-eq's color path is YCrCb, not a LUT).
    lut_fn: Optional[Callable[..., Any]] = None
    lut_needs_image: bool = False
    lut_ndims: Tuple[int, ...] = (2, 3)
    #: streaming twin of ``lut_fn`` for global-statistics ops whose apply
    #: pass is exactly a 256-entry table on uint8: ``stats_lut_fn(stats,
    #: dyn, **static) -> (256,) uint8`` derives the table from the RESOLVED
    #: global statistics, letting the streaming engine open a composed LUT
    #: run at the global op (one HBM pass for e.g. hist-eq apply +
    #: brightness/contrast instead of two).  Gated by ``lut_ndims``.
    stats_lut_fn: Optional[Callable[..., Any]] = None
    #: extraction twin producing tabular records (pandas DataFrame), the
    #: reference's ``*_data`` functions (``core/extraction.py:70-443``)
    data_fn: Optional[Callable[..., Any]] = None
    #: jittable device feature kernel for extraction families whose
    #: golden_fn output is a text-annotated image: ``feature_fn(img,
    #: **static) -> array pytree`` computes the NUMBERS on the accelerator
    #: (data_fn routes through it off the CPU); the text raster stays host-side
    feature_fn: Optional[Callable[..., Any]] = None

    @property
    def identifier(self) -> str:
        return self.schema.identifier

    def halo_for(self, params: Mapping[str, Any]) -> int:
        if callable(self.halo):
            return int(self.halo(dict(params)))
        return int(self.halo)

    def split_params(
        self, params: Mapping[str, Any], shape: Optional[Tuple[int, ...]] = None
    ) -> SplitResult:
        """Partition params, passing the input shape to shape-aware splits
        (e.g. FCM membership inits sized by pixel count)."""

        try:
            nargs = len(inspect.signature(self.split).parameters)
        except (TypeError, ValueError):
            nargs = 1
        if nargs >= 2:
            return self.split(params, shape)
        return self.split(params)

    @property
    def streamable_global(self) -> bool:
        """True when this global-stats op has a two-pass tile decomposition."""

        return (
            self.tile_stats_fn is not None
            and self.merge_stats_fn is not None
            and self.apply_stats_fn is not None
        )

    def __call__(self, image: np.ndarray, **params: Any) -> np.ndarray:
        """Host-convenience execution through the golden path."""

        return self.golden_fn(image, **params)


def call_with_position(fn: Callable[..., Any], *args: Any, box=None, frame_shape=None, **kwargs: Any):
    """Invoke a streaming-stats fn, forwarding ``box``/``frame_shape`` only
    when its signature declares them (most ops are position-free)."""

    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        params = {}
    if "box" in params:
        kwargs["box"] = box
    if "frame_shape" in params:
        kwargs["frame_shape"] = frame_shape
    return fn(*args, **kwargs)


_REGISTRY: Dict[str, OpImpl] = {}


def register(impl: OpImpl) -> OpImpl:
    _REGISTRY[impl.identifier] = impl
    return impl


def register_op(identifier: str, **kwargs: Any) -> OpImpl:
    return register(OpImpl(schema=op_by_identifier(identifier), **kwargs))


def get_impl(identifier: str) -> OpImpl:
    """Look up an implementation, importing the op modules on first use."""

    if identifier not in _REGISTRY:
        _ensure_loaded()
    return _REGISTRY[identifier]


def all_impls() -> Dict[str, OpImpl]:
    _ensure_loaded()
    return dict(_REGISTRY)


_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    # Importing these modules registers every built-in op.
    from yamimageprocessor_tpu.ops import extraction  # noqa: F401
    from yamimageprocessor_tpu.ops import preprocess  # noqa: F401
    from yamimageprocessor_tpu.ops import segmentation  # noqa: F401

    _loaded = True


__all__ = [
    "OpImpl",
    "register",
    "register_op",
    "get_impl",
    "all_impls",
    "call_with_position",
    "Stage",
]
