"""Unified application launcher — the process entry layer.

Parity with ``core/application_launcher.py:30-279`` and the thin
``segmentation25.py`` entry script: stage launch specifications with lazy
pane factories, the persisted startup stage selection, diagnostics
plumbed into the configuration, a shared cross-stage controller, and the
bootstrap → select → build-panes → run → shutdown lifecycle (including
the "nothing selected ⇒ clean exit 0" paths).

Redesign: the shell is headless — ``launch_stage_applications``
returns through a ``run`` callable that receives a ``StageSession``
(app core + controller + instantiated panes) instead of spinning a Qt
event loop; the CLI, tests, or any GUI shell can host the session.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from yamimageprocessor_tpu.ops.schema import Stage

LOGGER = logging.getLogger(__name__)


@dataclass(frozen=True)
class StagePaneFactoryResult:
    """Pane registration metadata (``core/application_launcher.py:21-28``)."""

    pane: object
    status_message: Optional[str] = None


@dataclass(frozen=True)
class StageApplicationSpec:
    """How to bootstrap one processing stage
    (``core/application_launcher.py:30-40``)."""

    stage: Stage
    title: str
    pane_factory: Callable[[object, object], StagePaneFactoryResult]
    description: str = ""
    enabled_by_default: bool = True


def _preprocessing_pane(core, controller) -> StagePaneFactoryResult:
    from yamimageprocessor_tpu.ui.panes import PreprocessingPane

    return StagePaneFactoryResult(pane=PreprocessingPane(core, controller))


def _segmentation_pane(core, controller) -> StagePaneFactoryResult:
    from yamimageprocessor_tpu.ui.panes import SegmentationPane

    return StagePaneFactoryResult(pane=SegmentationPane(core, controller))


def _extraction_pane(core, controller) -> StagePaneFactoryResult:
    from yamimageprocessor_tpu.ui.panes import ExtractionPane

    return StagePaneFactoryResult(pane=ExtractionPane(core, controller))


def default_stage_specifications() -> List[StageApplicationSpec]:
    """Default stage specs (``core/application_launcher.py:42-70``:
    preprocessing + segmentation on by default, extraction opt-in)."""

    return [
        StageApplicationSpec(
            stage=Stage.PREPROCESSING,
            title="Preprocessing",
            description="Prepare imagery before segmentation or feature extraction.",
            pane_factory=_preprocessing_pane,
            enabled_by_default=True,
        ),
        StageApplicationSpec(
            stage=Stage.SEGMENTATION,
            title="Segmentation",
            description="Isolate meaningful regions from the prepared imagery.",
            pane_factory=_segmentation_pane,
            enabled_by_default=True,
        ),
        StageApplicationSpec(
            stage=Stage.ANALYSIS,
            title="Feature Extraction",
            description="Extract quantitative descriptors from segmented data.",
            pane_factory=_extraction_pane,
            enabled_by_default=False,
        ),
    ]


@dataclass
class StageSession:
    """A running shell session: core services, the shared cross-stage
    controller, and the instantiated panes keyed by stage."""

    app_core: object
    controller: object
    panes: Dict[Stage, object] = field(default_factory=dict)
    status_messages: List[str] = field(default_factory=list)

    def pane(self, stage: Stage):
        return self.panes.get(stage)


def launch_stage_applications(
    stage_specs: Sequence[StageApplicationSpec],
    *,
    configuration_factory: Optional[Callable[[], object]] = None,
    selection_provider: Optional[Callable[[object, Sequence[StageApplicationSpec]], object]] = None,
    run: Optional[Callable[[StageSession], int]] = None,
    initial_diagnostics: bool = False,
) -> int:
    """Bootstrap the shell from ``stage_specs``
    (``core/application_launcher.py:153-263`` lifecycle).

    ``selection_provider(app_core, specs)`` returns a ``StartupSelection``
    (defaults to the persisted one — the headless StartupDialog); stages it
    leaves out are not instantiated.  ``run(session)`` hosts the session
    and returns the exit code; when omitted the session is built, verified
    and torn down (a smoke launch).  Returns 0 when the selection is
    declined/empty, mirroring the reference's early-exit paths.
    """

    if not stage_specs:
        raise ValueError("At least one stage specification must be provided.")

    from yamimageprocessor_tpu.core.app_core import AppConfiguration, AppCore
    from yamimageprocessor_tpu.ui.startup import StartupSelection

    configuration_factory = configuration_factory or (
        lambda: AppConfiguration(diagnostics=bool(initial_diagnostics))
    )
    configuration = configuration_factory()

    app_core = AppCore(configuration)
    app_core.bootstrap()
    try:
        if selection_provider is not None:
            selection = selection_provider(app_core, stage_specs)
        else:
            selection = StartupSelection.load(app_core.settings)
            if initial_diagnostics:
                selection.diagnostics = True
        if selection is None or not getattr(selection, "stages", None):
            return 0  # declined / nothing selected (reference :199-210)

        selection.save(app_core.settings)
        app_core.settings.set(
            "diagnostics/enabled", bool(getattr(selection, "diagnostics", False))
        )

        from yamimageprocessor_tpu.ui.controller import UnifiedPipelineController

        controller = UnifiedPipelineController(app_core)
        session = StageSession(app_core=app_core, controller=controller)

        spec_lookup: Mapping[Stage, StageApplicationSpec] = {
            spec.stage: spec for spec in stage_specs
        }
        for stage in selection.stages:
            spec = spec_lookup.get(stage)
            if spec is None:
                continue
            registration = spec.pane_factory(app_core, controller)
            session.panes[stage] = registration.pane
            if registration.status_message:
                session.status_messages.append(registration.status_message)
            LOGGER.info("Stage pane ready: %s", spec.title)

        if not session.panes:
            return 0  # no pane could be built (reference :243-249)

        if run is not None:
            return int(run(session))
        return 0
    finally:
        app_core.shutdown()


def main() -> int:
    """Entry point (``core/application_launcher.py:266-269`` /
    ``segmentation25.py``)."""

    return launch_stage_applications(default_stage_specifications())


__all__ = [
    "StageApplicationSpec",
    "StagePaneFactoryResult",
    "StageSession",
    "default_stage_specifications",
    "launch_stage_applications",
    "main",
]


if __name__ == "__main__":
    raise SystemExit(main())
