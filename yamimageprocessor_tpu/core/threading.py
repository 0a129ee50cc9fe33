"""Host async executor: task pool with pause/cancel/progress.

Capability parity with both reference controllers
(``core/thread_controller.py:14-250`` and
``yam_processor/core/threading.py:52-373``): tasks carry ids, names,
progress in [0,1], cooperative cancel events and a task-local ``current()``;
the controller offers ``submit``/``run_task``/``run_pipeline``, a global
pause gate (held while an update notice is pending,
``core/app_core.py:1156-1173``), ``cancel``/``cancel_all`` and lifecycle
listeners feeding the diagnostics task stream.

On the accelerator the worker threads are dispatchers: they feed device queues
(jax dispatch is async), so "cancellation" means dropping pending host
dispatch — in-flight device work completes and is discarded.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

LOGGER = logging.getLogger(__name__)


class OperationCancelled(RuntimeError):
    """Cooperative cancellation (``core/thread_controller.py:14``)."""


class TaskStatus(Enum):
    PENDING = "pending"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


_current_task = threading.local()


@dataclass
class ThreadTask:
    """Handle for one submitted unit of work."""

    task_id: int
    name: str
    cancel_event: threading.Event = field(default_factory=threading.Event)
    status: TaskStatus = TaskStatus.PENDING
    progress: float = 0.0
    error: Optional[BaseException] = None
    future: Optional[Future] = None

    def cancel(self) -> None:
        self.cancel_event.set()
        if self.future is not None:
            self.future.cancel()

    def cancelled(self) -> bool:
        return self.cancel_event.is_set()

    def check_cancelled(self) -> None:
        if self.cancel_event.is_set():
            raise OperationCancelled()

    def set_progress(self, fraction: float) -> None:
        self.progress = max(0.0, min(1.0, float(fraction)))

    def done(self) -> bool:
        return self.status in (
            TaskStatus.FINISHED,
            TaskStatus.FAILED,
            TaskStatus.CANCELLED,
        )

    @staticmethod
    def current() -> Optional["ThreadTask"]:
        return getattr(_current_task, "task", None)


TaskListener = Callable[[str, ThreadTask], None]


class ThreadController:
    """Bounded worker pool with pause gate and lifecycle events."""

    def __init__(self, max_workers: int = 4) -> None:
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="yam-task"
        )
        self._ids = itertools.count(1)
        self._MAX_RETAINED = 256
        self._tasks: Dict[int, ThreadTask] = {}
        self._lock = threading.Lock()
        self._resume = threading.Event()
        self._resume.set()
        self._listeners: List[TaskListener] = []

    # ------------------------------------------------------------------
    # pause gate
    def pause(self) -> None:
        self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    @property
    def paused(self) -> bool:
        return not self._resume.is_set()

    # ------------------------------------------------------------------
    def add_listener(self, listener: TaskListener) -> None:
        if listener not in self._listeners:
            self._listeners.append(listener)

    def remove_listener(self, listener: TaskListener) -> None:
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def _notify(self, event: str, task: ThreadTask) -> None:
        for listener in tuple(self._listeners):
            try:
                listener(event, task)
            except Exception:
                LOGGER.debug("Task listener failed", exc_info=True)

    # ------------------------------------------------------------------
    def submit(
        self,
        fn: Callable[..., Any],
        *args: Any,
        name: str = "task",
        on_finished: Optional[Callable[[Any], None]] = None,
        on_error: Optional[Callable[[BaseException], None]] = None,
        on_cancelled: Optional[Callable[[], None]] = None,
        on_progress: Optional[Callable[[float], None]] = None,
        on_intermediate: Optional[Callable[[Any], None]] = None,
        **kwargs: Any,
    ) -> ThreadTask:
        """Run ``fn`` on a worker.  If ``fn`` accepts them, the keyword
        arguments ``cancel_event``, ``progress_callback`` and
        ``intermediate_callback`` are injected (the reference runnable's
        signature sniffing, ``core/thread_controller.py:47-90``)."""

        task = ThreadTask(task_id=next(self._ids), name=name)
        with self._lock:
            self._tasks[task.task_id] = task
            # bound the registry: finished tasks beyond a small history
            # window are dropped, or a long session pins every task (and
            # any images its error traceback references) forever
            if len(self._tasks) > self._MAX_RETAINED:
                for tid in [
                    t
                    for t, tk in self._tasks.items()
                    if tk.done() and t != task.task_id
                ][: len(self._tasks) - self._MAX_RETAINED]:
                    del self._tasks[tid]

        import inspect

        try:
            accepted = set(inspect.signature(fn).parameters)
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in inspect.signature(fn).parameters.values()
            )
        except (TypeError, ValueError):
            accepted = set()
            has_var_kw = False

        def progress(fraction: float) -> None:
            task.set_progress(fraction)
            if on_progress is not None:
                on_progress(task.progress)
            self._notify("progress", task)

        injectable = {
            "cancel_event": task.cancel_event,
            "progress_callback": progress,
            "intermediate_callback": on_intermediate,
        }
        for key, value in injectable.items():
            if (key in accepted or has_var_kw) and key not in kwargs:
                kwargs[key] = value

        def runner() -> Any:
            _current_task.task = task
            task.status = TaskStatus.RUNNING
            self._notify("started", task)
            try:
                self._resume.wait()
                task.check_cancelled()
                result = fn(*args, **kwargs)
                task.check_cancelled()
                task.status = TaskStatus.FINISHED
                task.set_progress(1.0)
                self._notify("finished", task)
                if on_finished is not None:
                    on_finished(result)
                return result
            except OperationCancelled:
                task.status = TaskStatus.CANCELLED
                self._notify("cancelled", task)
                if on_cancelled is not None:
                    on_cancelled()
                return None
            except BaseException as exc:  # noqa: BLE001 - reported to caller
                task.status = TaskStatus.FAILED
                task.error = exc
                self._notify("failed", task)
                if on_error is not None:
                    on_error(exc)
                else:
                    LOGGER.exception("Task '%s' failed", task.name)
                return None
            finally:
                _current_task.task = None

        task.future = self._executor.submit(runner)

        def _executor_cancelled(fut: Future) -> None:
            # future.cancel() succeeded before the runner dequeued: the runner
            # never runs, so surface the cancellation here (otherwise the task
            # stays PENDING and on_cancelled never fires)
            if fut.cancelled():
                task.status = TaskStatus.CANCELLED
                self._notify("cancelled", task)
                if on_cancelled is not None:
                    on_cancelled()

        task.future.add_done_callback(_executor_cancelled)
        return task

    # reference-convenience aliases
    run_task = submit

    def run_pipeline(
        self,
        pipeline: Any,
        image: Any,
        *,
        name: str = "pipeline",
        **callbacks: Any,
    ) -> ThreadTask:
        """Apply a pipeline asynchronously (``thread_controller.py:226-250``)."""

        return self.submit(lambda: pipeline.apply(image), name=name, **callbacks)

    # ------------------------------------------------------------------
    def cancel(self, task_id: int) -> None:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is not None:
            task.cancel()

    def cancel_all(self) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
        for task in tasks:
            task.cancel()

    def task(self, task_id: int) -> Optional[ThreadTask]:
        with self._lock:
            return self._tasks.get(task_id)

    def tasks(self) -> List[ThreadTask]:
        with self._lock:
            return list(self._tasks.values())

    def wait_all(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for task in self.tasks():
            if task.future is None:
                continue
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            try:
                task.future.result(timeout=remaining)
            except Exception:
                pass

    def shutdown(self, wait: bool = True) -> None:
        self.cancel_all()
        self._resume.set()
        self._executor.shutdown(wait=wait)


__all__ = [
    "OperationCancelled",
    "TaskStatus",
    "ThreadTask",
    "ThreadController",
]
