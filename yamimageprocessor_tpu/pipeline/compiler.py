"""Fused-chain compiler: an enabled step list becomes one XLA program.

This is the device replacement for the reference's hot loop
(``processing/pipeline_cache.py:352-414``), which re-ran a full-frame
numpy/OpenCV pass per step and copied the frame between steps.  Here the
chain is traced once per (shape, dtype, structure) signature and compiled to
a single fused executable; XLA fuses elementwise stages into neighboring
stencils so intermediate frames never round-trip HBM unless they are
requested as preview intermediates.

* Parameter VALUES travel as dynamic inputs (LUTs, filter taps, scalars) —
  tweaking brightness or gamma re-runs the same executable, no recompile.
* Structural params (kernel sizes, crop geometry, channel choices) are baked
  in; changing them recompiles, exactly like a shape change.
* Host-only ops (GrabCut, active contour — the reference's slow paths too)
  split the chain into device segments around a host call.
* ``batch=N`` vmaps the whole chain for fused multi-frame throughput.

Compiled executables are cached in a bounded LRU keyed by the chain
signature; the cache is the compiled-program analogue of the reference's
result cache and is shared across PipelineManager/PipelineCache instances.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from yamimageprocessor_tpu.pipeline.step import PipelineStep


def _static_key(static: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, repr(v)) for k, v in static.items()))


@dataclass
class _SegmentPlan:
    kind: str  # "device" | "host"
    indices: List[int]  # positions in the full step list


class CompiledChain:
    """Executable for one step-list structure at one input signature."""

    def __init__(
        self,
        steps: Sequence[PipelineStep],
        shape: Tuple[int, ...],
        dtype: Any,
        batch: int = 0,
    ) -> None:
        import jax

        from yamimageprocessor_tpu.utils.jaxcache import enable_persistent_cache

        enable_persistent_cache()  # idempotent
        self.steps = [s.clone() for s in steps]
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.batch = int(batch)
        self._jax = jax

        self.plans: List[_SegmentPlan] = []
        current: Optional[_SegmentPlan] = None
        for i, step in enumerate(self.steps):
            runs_on_device = (not step.enabled) or step.is_device_capable()
            kind = "device" if runs_on_device else "host"
            if current is None or current.kind != kind:
                current = _SegmentPlan(kind, [])
                self.plans.append(current)
            current.indices.append(i)

        # Build per-device-segment jitted functions, tracking shapes with
        # eval_shape so shape-aware splits (FCM) and reshaping ops (crop)
        # compose correctly.
        self._segment_fns: Dict[int, Any] = {}
        self._segment_dyn: Dict[int, List[Dict[str, Any]]] = {}
        self._statics: Dict[int, Dict[str, Any]] = {}
        #: seg_idx -> per-step INPUT item shapes (shape-aware dyn splits,
        #: e.g. FCM membership inits, must see the same evolved shapes at
        #: refresh time that the trace saw at build time)
        self._segment_shapes: Dict[int, List[Tuple[int, ...]]] = {}
        #: seg_idx -> {segment-local start: run length} of composed LUT runs
        self.lut_runs: Dict[int, Dict[int, int]] = {}

        spec = jax.ShapeDtypeStruct(self.shape, self.dtype)
        for seg_idx, plan in enumerate(self.plans):
            if plan.kind == "host":
                # host output shapes are unknowable without running; device
                # segments after a host op are built lazily at run time
                spec = None
                continue
            if spec is None:
                # deferred: built lazily on first run when shape is known
                self._segment_fns[seg_idx] = None
                continue
            fn, dyns, statics, spec, runs, shapes = self._build_device_segment(
                plan, spec
            )
            self._segment_fns[seg_idx] = fn
            self._segment_dyn[seg_idx] = dyns
            self._statics[seg_idx] = statics
            self._segment_shapes[seg_idx] = shapes
            self.lut_runs[seg_idx] = runs

    # ------------------------------------------------------------------
    def _build_device_segment(self, plan: _SegmentPlan, spec):
        import jax
        import jax.numpy as jnp

        steps = [self.steps[i] for i in plan.indices]
        cur = spec
        dyn_per_step: List[Dict[str, Any]] = []
        static_per_step: List[Dict[str, Any]] = []
        shapes_per_step: List[Tuple[int, ...]] = []
        lut_ok: List[bool] = []  # LUT-expressible at this chain position?
        item_shape = cur.shape[1:] if self.batch else cur.shape

        for step in steps:
            shapes_per_step.append(tuple(item_shape))
            if not step.enabled or step.impl is None:
                dyn_per_step.append({})
                static_per_step.append({})
                lut_ok.append(False)
                continue
            lut_ok.append(
                step.impl.lut_fn is not None
                and np.dtype(cur.dtype) == np.uint8
                and len(item_shape) in step.impl.lut_ndims
            )
            static, dyn = step.impl.split_params(step.params, item_shape)
            dyn_per_step.append(dyn)
            static_per_step.append(static)
            # advance the item shape via eval_shape on a single item
            item_spec = jax.ShapeDtypeStruct(item_shape, cur.dtype)
            dyn_specs = {
                k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
                for k, v in dyn.items()
            }
            out_spec = jax.eval_shape(
                lambda img, d, _s=step, _st=static: _s.impl.device_fn(img, d, **_st),
                item_spec,
                dyn_specs,
            )
            item_shape = out_spec.shape
            cur = jax.ShapeDtypeStruct(
                (cur.shape[0],) + out_spec.shape if self.batch else out_spec.shape,
                out_spec.dtype,
            )

        # Maximal runs of LUT-expressible steps collapse into ONE table
        # application: compose(L2, L1)[v] == L2[L1[v]] exactly on uint8, so
        # every step's output is reproduced bit-identically as
        # ``composed_prefix[run_input]`` while the full-frame intermediate
        # applies become dead code whenever only the run's last output is
        # consumed (bench/run_final under jit) — one HBM pass instead of N.
        # Stats-derived tables (lut_needs_image, e.g. hist-eq) may only OPEN
        # a run: their table is built from the run input, which is exactly
        # the frame they would have seen sequentially.
        lut_runs: Dict[int, int] = {}
        i = 0
        while i < len(steps):
            if lut_ok[i]:
                j = i + 1
                while (
                    j < len(steps)
                    and lut_ok[j]
                    and not steps[j].impl.lut_needs_image
                ):
                    j += 1
                if j - i >= 2:
                    lut_runs[i] = j - i
                i = j
            else:
                i += 1

        def single(img, dyn_list):
            from yamimageprocessor_tpu.ops.lutops import apply_lut_j

            outs = []
            cur_img = img
            pos = 0
            while pos < len(steps):
                length = lut_runs.get(pos, 0)
                if length:
                    x = cur_img
                    composed = None
                    for j in range(pos, pos + length):
                        lut = steps[j].impl.lut_fn(
                            x, dyn_list[j], **static_per_step[j]
                        ).astype(jnp.uint8)
                        composed = (
                            lut
                            if composed is None
                            else lut[composed.astype(jnp.int32)]
                        )
                        cur_img = apply_lut_j(x, composed)
                        outs.append(cur_img)
                    pos += length
                    continue
                step = steps[pos]
                if step.enabled and step.impl is not None:
                    cur_img = step.impl.device_fn(
                        cur_img, dyn_list[pos], **static_per_step[pos]
                    )
                outs.append(cur_img)
                pos += 1
            return tuple(outs)

        if self.batch:
            inner = jax.vmap(single, in_axes=(0, None))
            fn = jax.jit(inner)
        else:
            fn = jax.jit(single)
        return fn, dyn_per_step, static_per_step, cur, lut_runs, shapes_per_step

    # ------------------------------------------------------------------
    def refresh_params(self, steps: Sequence[PipelineStep]) -> None:
        """Recompute the stored dynamic inputs (same structure).

        NOTE: per-call parameter overrides should go through ``run(image,
        steps=...)`` which derives dyn values locally — this method mutates
        shared state and is only for single-threaded reconfiguration.
        """

        self.steps = [s.clone() for s in steps]
        self._segment_dyn = self._dyn_for(self.steps)

    def _dyn_for(self, steps: Sequence[PipelineStep]) -> Dict[int, List[Dict[str, Any]]]:
        out: Dict[int, List[Dict[str, Any]]] = {}
        for seg_idx, plan in enumerate(self.plans):
            if plan.kind != "device" or self._segment_fns.get(seg_idx) is None:
                continue
            # per-step item shapes as recorded by the build-time eval_shape
            # walk: a reshaping step (crop) upstream means later shape-aware
            # splits must see the EVOLVED shape, not the chain input shape
            shapes = self._segment_shapes[seg_idx]
            dyns = []
            for pos, i in enumerate(plan.indices):
                step = steps[i]
                if step.enabled and step.impl is not None:
                    _, dyn = step.impl.split_params(step.params, shapes[pos])
                else:
                    dyn = {}
                dyns.append(dyn)
            out[seg_idx] = dyns
        return out

    def run(
        self,
        image: np.ndarray,
        steps: Optional[Sequence[PipelineStep]] = None,
    ) -> List[np.ndarray]:
        """Execute the chain; returns one output per step.

        ``steps`` (same structure, possibly different parameter VALUES)
        makes the call thread-safe: dynamic inputs are derived locally
        instead of read from shared state.
        """

        import jax.numpy as jnp

        active_steps = self.steps if steps is None else list(steps)
        segment_dyn = (
            self._segment_dyn if steps is None else self._dyn_for(active_steps)
        )
        outputs: List[Any] = [None] * len(active_steps)
        cur: Any = image
        for seg_idx, plan in enumerate(self.plans):
            if plan.kind == "host":
                cur = np.asarray(cur)
                for i in plan.indices:
                    if self.batch:
                        # host kernels are per-image: apply item-wise, never
                        # hand them the batched array (a golden_fn would
                        # read the batch axis as height/channels)
                        cur = np.stack(
                            [active_steps[i].apply(item) for item in cur]
                        )
                    else:
                        cur = active_steps[i].apply(cur)
                    outputs[i] = cur
                continue
            fn = self._segment_fns.get(seg_idx)
            if fn is None:
                # segment after a host op: run eagerly on device without a
                # prebuilt jit (host shapes unknown at build time)
                import jax

                cur_j = jnp.asarray(cur)
                item_shape = cur_j.shape[1:] if self.batch else cur_j.shape
                for i in plan.indices:
                    step = active_steps[i]
                    if step.enabled and step.impl is not None:
                        static, dyn = step.impl.split_params(step.params, item_shape)
                        dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
                        if self.batch:
                            cur_j = jax.vmap(
                                lambda im, _s=step, _st=static, _d=dyn_j: (
                                    _s.impl.device_fn(im, _d, **_st)
                                )
                            )(cur_j)
                        else:
                            cur_j = step.impl.device_fn(cur_j, dyn_j, **static)
                        item_shape = cur_j.shape[1:] if self.batch else cur_j.shape
                    outputs[i] = cur_j
                cur = cur_j
                continue
            cur_j = jnp.asarray(cur)
            dyn_list = [
                {k: jnp.asarray(v) for k, v in d.items()}
                for d in segment_dyn[seg_idx]
            ]
            outs = fn(cur_j, dyn_list)
            for i, out in zip(plan.indices, outs):
                outputs[i] = out
            cur = outs[-1] if outs else cur_j
        return outputs

    def run_final(
        self,
        image: np.ndarray,
        steps: Optional[Sequence[PipelineStep]] = None,
    ) -> np.ndarray:
        from yamimageprocessor_tpu.parallel.transfer import fetch

        outs = self.run(image, steps)
        return fetch(outs[-1]) if outs else np.asarray(image)

    def pure_callable(self):
        """(fn, dyn_list) for an all-device chain: ``fn(images, dyn_list)``
        is the UNJITTED traced function (one output per step) and
        ``dyn_list`` the host-derived dynamic inputs.  This is how harnesses
        (bench, ``flagship_forward``) embed the production chain inside their
        own jit/fori_loop scopes without re-deriving per-step plans — the
        benched code IS the pipeline code.
        """

        device_plans = [p for p in self.plans if p.kind == "device"]
        if len(self.plans) != len(device_plans) or len(device_plans) != 1:
            raise ValueError(
                "pure_callable requires a single all-device segment "
                f"(got {[p.kind for p in self.plans]})"
            )
        fn = self._segment_fns[0]
        # the stored jitted fn wraps `single`/`vmap(single)`; expose the
        # underlying traced callable so callers can embed it in their own jit
        inner = getattr(fn, "__wrapped__", fn)
        return inner, self._segment_dyn[0]


# ---------------------------------------------------------------------------
# bounded executable cache

_CACHE_CAP = 64
_cache: "OrderedDict[Tuple, CompiledChain]" = OrderedDict()
_cache_lock = threading.Lock()


def chain_structure_key(
    steps: Sequence[PipelineStep],
    shape: Tuple[int, ...],
    dtype: Any,
    batch: int = 0,
) -> Tuple:
    parts: List[Tuple] = []
    item_shape: Optional[Tuple[int, ...]] = (
        tuple(shape[1:]) if batch else tuple(shape)
    )
    for step in steps:
        if not step.enabled:
            parts.append((step.name, False))
            continue
        if step.impl is not None:
            static, _ = step.impl.split_params(step.params, item_shape)
            parts.append((step.op_id, True, _static_key(static)))
            if step.impl.reshapes:
                # downstream of a reshaping op the item shape is no longer
                # the chain input shape; None keeps shape-aware splits from
                # deriving statics (and hence cache keys) from a wrong shape
                item_shape = None
        else:
            parts.append((step.name, True, id(step.function), _static_key(step.params)))
            item_shape = None  # arbitrary host callables may reshape
    return (tuple(shape), str(np.dtype(dtype)), int(batch), tuple(parts))


def get_compiled_chain(
    steps: Sequence[PipelineStep],
    shape: Tuple[int, ...],
    dtype: Any,
    batch: int = 0,
) -> CompiledChain:
    """Fetch-or-build the executable for this chain structure."""

    key = chain_structure_key(steps, shape, dtype, batch)
    with _cache_lock:
        chain = _cache.get(key)
        if chain is not None:
            _cache.move_to_end(key)
    if chain is None:
        chain = CompiledChain(steps, shape, dtype, batch)
        with _cache_lock:
            _cache[key] = chain
            while len(_cache) > _CACHE_CAP:
                _cache.popitem(last=False)
    # parameter VALUES are supplied per call via run(image, steps=...) so a
    # shared cached chain never carries caller-specific state
    return chain


def clear_compiled_cache() -> None:
    with _cache_lock:
        _cache.clear()


__all__ = [
    "CompiledChain",
    "get_compiled_chain",
    "chain_structure_key",
    "clear_compiled_cache",
]
