"""AppCore: the application context owning every service and the device.

Capability parity with the reference cores (``core/app_core.py:43-1281``
merged with ``yam_processor/core/app_core.py:27-200``): bootstrap/shutdown
lifecycle, session temp root seeding the cache/recovery default dirs,
settings, IO, autosave+recovery, thread controller, plugin discovery behind
the signature gate, a module catalog keyed by stage with enabled flags, the
unified PipelineManager built from module templates, update checks (pausing
the executor while a notice is pending) and the consent-gated telemetry.

Device addition: the context owns the jax device view (mesh factory,
backend info) so every service shares one accelerator configuration.
"""
from __future__ import annotations

import json
import logging
import shutil
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from yamimageprocessor_tpu.core import path_sanitizer
from yamimageprocessor_tpu.core.io_manager import IOManager
from yamimageprocessor_tpu.core.logging import init_logging
from yamimageprocessor_tpu.core.module_loader import ModuleLoader, ModuleRegistry
from yamimageprocessor_tpu.core.persistence import AutosaveManager
from yamimageprocessor_tpu.core.recovery import RecoveryManager, RecoverySummary
from yamimageprocessor_tpu.core.settings import SettingsManager
from yamimageprocessor_tpu.core.signing import (
    ModuleSignatureVerifier,
    TrustStoreError,
)
from yamimageprocessor_tpu.core.telemetry import TelemetryGate
from yamimageprocessor_tpu.core.threading import ThreadController
from yamimageprocessor_tpu.core.updates import (
    UpdateDispatcher,
    UpdateMetadata,
    fetch_update_metadata,
)
from yamimageprocessor_tpu.ops.schema import Stage

LOGGER = logging.getLogger(__name__)


@dataclass
class AppConfiguration:
    """Bootstrap configuration (``core/app_core.py:43-75``)."""

    organization: str = "MicroscopicApp"
    application: str = "ImageProcessor"
    plugin_packages: Tuple[str, ...] = ("yamimageprocessor_tpu.modules",)
    plugin_directories: Tuple[Path, ...] = ()
    trust_store: Optional[Path] = None
    require_signatures: bool = False
    #: None = leave the persisted ``autosave/interval_seconds`` setting
    #: alone (default 120 s); a value seeds it at bootstrap
    autosave_interval_seconds: Optional[float] = None
    backup_retention: int = 5
    allowed_roots: Tuple[Path, ...] = ()
    diagnostics: bool = False
    update_endpoint: Optional[str] = None
    max_workers: int = 4
    settings_path: Optional[Path] = None
    session_root: Optional[Path] = None
    mesh_devices: Optional[int] = None


class AppCore:
    """Service container with an explicit bootstrap lifecycle."""

    def __init__(self, configuration: Optional[AppConfiguration] = None) -> None:
        self.configuration = configuration or AppConfiguration()
        self._bootstrapped = False
        self._lock = threading.Lock()
        self._registry = ModuleRegistry()
        self._module_instances: Dict[str, Any] = {}
        self._pipeline_manager = None
        self._stage_templates: Dict[Stage, List[Any]] = {}
        self._session_root: Optional[Path] = None
        self._owns_session_root = False
        self.update_dispatcher = UpdateDispatcher()
        self._recovery_summary: Optional[RecoverySummary] = None

        self.settings: Optional[SettingsManager] = None
        self.io_manager: Optional[IOManager] = None
        self.thread_controller: Optional[ThreadController] = None
        self.autosave: Optional[AutosaveManager] = None
        self.recovery: Optional[RecoveryManager] = None
        self.telemetry: Optional[TelemetryGate] = None
        self.pipeline_cache = None

    # ------------------------------------------------------------------
    # lifecycle
    def ensure_bootstrapped(self) -> "AppCore":
        if not self._bootstrapped:
            self.bootstrap()
        return self

    def bootstrap(self) -> None:
        with self._lock:
            if self._bootstrapped:
                return
            cfg = self.configuration

            self._prepare_session_root()
            self._refresh_allowed_roots()
            log_dir = self._session_root / "logs"
            init_logging(log_dir, diagnostics=cfg.diagnostics)

            from yamimageprocessor_tpu.core.settings import default_storage_path

            # settings PERSIST by default (the reference's QSettings always
            # does); in-memory only when the caller explicitly opts out via
            # a falsy-but-set path is not supported — pass a tmp path
            storage = cfg.settings_path or default_storage_path(
                cfg.organization, cfg.application
            )
            Path(storage).parent.mkdir(parents=True, exist_ok=True)
            self.settings = SettingsManager(
                cfg.organization,
                cfg.application,
                storage_path=storage,
            )
            if cfg.diagnostics:
                self.settings.set("diagnostics/enabled", True)
            if cfg.autosave_interval_seconds is not None:
                self.settings.set(
                    "autosave/interval_seconds",
                    float(cfg.autosave_interval_seconds),
                )

            from yamimageprocessor_tpu.pipeline.cache import PipelineCache

            self.pipeline_cache = PipelineCache(
                self.settings,
                cache_directory=self._session_root / "pipeline_cache",
            )
            self.io_manager = IOManager(
                self.settings, backup_retention=cfg.backup_retention
            )
            # recovery must survive the session: under an explicit
            # session_root it lives there (caller owns persistence), but
            # the default throwaway mkdtemp root would orphan every crash
            # marker and autosave — those go to the stable state dir
            # beside the settings file instead
            if cfg.session_root is not None:
                recovery_root = self._session_root / "recovery"
            else:
                recovery_root = Path(storage).parent / "recovery"
            self.recovery = RecoveryManager(recovery_root)
            self._recovery_summary = self.recovery.inspect_startup()
            self.recovery.begin_session({"application": cfg.application})
            self.autosave = AutosaveManager(
                self.settings, self.io_manager, self.recovery
            )
            self.thread_controller = ThreadController(max_workers=cfg.max_workers)
            self.telemetry = TelemetryGate(self.settings)

            self._discover_plugins()
            self._bootstrapped = True
            LOGGER.info(
                "AppCore bootstrapped",
                extra={"component": "app_core"},
            )

    def shutdown(self) -> None:
        with self._lock:
            if not self._bootstrapped:
                return
            try:
                if self.autosave is not None:
                    self.autosave.shutdown()
                if self.thread_controller is not None:
                    self.thread_controller.shutdown()
                if self.recovery is not None:
                    self.recovery.end_session()
            finally:
                if self._owns_session_root and self._session_root is not None:
                    shutil.rmtree(self._session_root, ignore_errors=True)
                self._bootstrapped = False

    def __enter__(self) -> "AppCore":
        return self.ensure_bootstrapped()

    def __exit__(self, *exc_info: Any) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # session dirs / sandbox
    def _prepare_session_root(self) -> None:
        """Temp session root with cache + recovery dirs
        (``core/app_core.py:973-1031``); also seeds the class-level default
        directories used when managers are constructed bare."""

        cfg = self.configuration
        if cfg.session_root is not None:
            self._session_root = Path(cfg.session_root)
            self._session_root.mkdir(parents=True, exist_ok=True)
            self._owns_session_root = False
        else:
            self._session_root = Path(
                tempfile.mkdtemp(prefix=f"{cfg.application.lower()}-session-")
            )
            self._owns_session_root = True
        (self._session_root / "pipeline_cache").mkdir(exist_ok=True)
        (self._session_root / "recovery").mkdir(exist_ok=True)

        from yamimageprocessor_tpu.pipeline.cache import PipelineCache
        from yamimageprocessor_tpu.pipeline.manager import PipelineManager

        PipelineCache.set_default_cache_directory(
            self._session_root / "pipeline_cache"
        )
        PipelineManager.set_default_cache_directory(
            self._session_root / "pipeline_cache"
        )
        PipelineManager.set_default_recovery_root(self._session_root / "recovery")

    @property
    def session_root(self) -> Optional[Path]:
        return self._session_root

    @property
    def recovery_summary(self) -> Optional[RecoverySummary]:
        return self._recovery_summary

    def _refresh_allowed_roots(self) -> None:
        roots: List[Path] = list(self.configuration.allowed_roots)
        if self._session_root is not None:
            roots.append(self._session_root)
        if not roots:
            roots.append(Path.cwd())
        path_sanitizer.configure_allowed_roots(roots)

    # ------------------------------------------------------------------
    # device context
    def device_backend(self) -> str:
        import jax

        return jax.default_backend()

    def make_mesh(self, n_devices: Optional[int] = None, axis: str = "shard"):
        from yamimageprocessor_tpu.parallel.mesh import make_mesh

        return make_mesh(n_devices or self.configuration.mesh_devices, axis)

    # ------------------------------------------------------------------
    # plugins / modules
    def _discover_plugins(self) -> None:
        cfg = self.configuration
        verifier: Optional[ModuleSignatureVerifier] = None
        if cfg.trust_store is not None:
            try:
                verifier = ModuleSignatureVerifier(trust_store=cfg.trust_store)
            except TrustStoreError:
                LOGGER.warning("Trust store unusable; signature gate closed")
                if cfg.require_signatures:
                    return
        loader = ModuleLoader(
            verifier, require_signatures=cfg.require_signatures
        )
        for package in cfg.plugin_packages:
            loader.discover_package(package, self)
        for directory in cfg.plugin_directories:
            loader.discover_path(Path(directory), self)

    def register_module(self, module_or_cls: Any) -> None:
        """Accepts a ModuleBase subclass or instance
        (``core/app_core.py:753-879``)."""

        module = module_or_cls() if isinstance(module_or_cls, type) else module_or_cls
        self._registry.register(module)
        self._module_instances[module.metadata.identifier] = module
        self._pipeline_manager = None  # invalidate built manager

    def modules(self, stage: Optional[Stage] = None) -> List[Any]:
        return self._registry.modules(stage)

    def get_module(self, identifier: str):
        return self._registry.get(identifier)

    def iter_enabled_modules(self, stage: Optional[Stage] = None):
        return self._registry.iter_enabled(stage)

    def set_module_enabled(self, identifier: str, enabled: bool) -> None:
        self._registry.set_enabled(identifier, enabled)
        if self._pipeline_manager is not None:
            try:
                self._pipeline_manager.set_step_enabled(identifier, enabled)
            except KeyError:
                pass

    def is_module_enabled(self, identifier: str) -> bool:
        return self._registry.is_enabled(identifier)

    # ------------------------------------------------------------------
    # unified pipeline manager
    def get_pipeline_manager(self):
        self.ensure_bootstrapped()
        if self._pipeline_manager is None:
            self._pipeline_manager = self._build_pipeline_manager()
        return self._pipeline_manager

    def _build_pipeline_manager(self):
        """One ordered step list from module templates, partitioned into
        stage ranges (``core/app_core.py:361-454``)."""

        from yamimageprocessor_tpu.pipeline.manager import PipelineManager

        steps = []
        self._stage_templates = {}
        for stage in (Stage.PREPROCESSING, Stage.SEGMENTATION, Stage.ANALYSIS):
            stage_steps = []
            for module in self._registry.modules(stage):
                step = module.create_pipeline_step()
                step.enabled = self._registry.is_enabled(
                    module.metadata.identifier
                )
                stage_steps.append(step)
            self._stage_templates[stage] = [s.clone() for s in stage_steps]
            steps.extend(stage_steps)
        return PipelineManager(steps)

    def stage_template_steps(self, stage: Stage):
        return [s.clone() for s in self._stage_templates.get(stage, [])]

    def stage_ranges(self) -> Dict[Stage, Tuple[int, int]]:
        manager = self.get_pipeline_manager()
        ranges: Dict[Stage, Tuple[int, int]] = {}
        start = 0
        steps = manager.steps
        for stage in (Stage.PREPROCESSING, Stage.SEGMENTATION, Stage.ANALYSIS):
            count = sum(1 for s in steps if s.stage == stage)
            ranges[stage] = (start, start + count)
            start += count
        return ranges

    # ------------------------------------------------------------------
    # pipeline JSON export/import (``core/app_core.py:406-426``)
    def export_pipeline_json(self, path: Path) -> None:
        manager = self.get_pipeline_manager()
        Path(path).write_text(
            json.dumps(manager.to_dict(), indent=2), encoding="utf-8"
        )

    def import_pipeline_json(self, path: Path) -> None:
        from yamimageprocessor_tpu.pipeline.step import PipelineStep

        payload = json.loads(Path(path).read_text(encoding="utf-8"))
        steps = [PipelineStep.from_dict(item) for item in payload.get("steps", [])]
        # normalize to stage-contiguous order (stable within a stage):
        # stage_ranges and the controller's range slicing assume the list
        # is grouped PRE -> SEG -> ANALYSIS; a hand-edited file with
        # interleaved stages would slice steps under the wrong stage
        order = {
            Stage.PREPROCESSING: 0,
            Stage.SEGMENTATION: 1,
            Stage.ANALYSIS: 2,
        }
        steps.sort(key=lambda s: order.get(s.stage, 3))
        self.get_pipeline_manager().replace_steps(steps, update_template=False)

    # ------------------------------------------------------------------
    # updates (``core/app_core.py:1072-1177``)
    def check_for_updates(self, *, asynchronous: bool = False):
        endpoint = self.configuration.update_endpoint
        if not endpoint:
            return None
        if asynchronous and self.thread_controller is not None:
            return self.thread_controller.submit(
                self._check_updates_blocking, name="update-check"
            )
        return self._check_updates_blocking()

    def _check_updates_blocking(self) -> Optional[UpdateMetadata]:
        metadata = fetch_update_metadata(self.configuration.update_endpoint)
        if metadata is not None and self._is_newer_version(metadata.version):
            self._handle_update_available(metadata)
            return metadata
        return None

    @staticmethod
    def _is_newer_version(advertised: str) -> bool:
        """True when the endpoint advertises something newer than the
        installed ``__version__`` (a routine poll reporting the current or
        an older version must not raise a notice, let alone pause work)."""

        from yamimageprocessor_tpu import __version__

        def parse(text: str):
            parts = []
            for token in str(text).strip().lstrip("vV").split("."):
                digits = "".join(ch for ch in token if ch.isdigit())
                parts.append(int(digits) if digits else 0)
            return tuple(parts)

        try:
            return parse(advertised) > parse(__version__)
        except Exception:
            # unparseable scheme: fall back to inequality
            return str(advertised).strip() != __version__

    def _handle_update_available(self, metadata: UpdateMetadata) -> None:
        # pause only when someone can acknowledge: a headless session with
        # no update listener would otherwise block every future task on a
        # resume that never comes
        if self.thread_controller is not None and self.update_dispatcher.has_listeners():
            self.thread_controller.pause()
        from yamimageprocessor_tpu.core.updates import format_update_notice

        LOGGER.info("%s", format_update_notice(metadata))
        self.update_dispatcher.dispatch(metadata)

    def acknowledge_update(self) -> None:
        self.update_dispatcher.acknowledge()
        if self.thread_controller is not None:
            self.thread_controller.resume()

    # ------------------------------------------------------------------
    # telemetry (``core/app_core.py:905-960``)
    def configure_telemetry(self, enabled: bool) -> None:
        self.ensure_bootstrapped()
        self.telemetry.configure(enabled)


__all__ = ["AppConfiguration", "AppCore"]
