"""rectpu_torch logging (a copy of ``rectpu/utils/logging.py``).

Design: all rectpu_torch loggers live under the ``rectpu_torch`` namespace and inherit
handlers from the package-root logger, which is configured exactly once
(lazily on first ``get_logger`` call, explicitly via ``configure``). This
replaces per-module handler management entirely — modules never attach or
remove handlers themselves.

Capability parity with the reference's logging channel (console progress +
optional debug log file, cf. the reference's src/logger.py): ``configure``
accepts a ``log_file`` that captures DEBUG-level records with rotation while
the console stays at INFO.

``fmt_metrics`` renders a metrics dict compactly for step/eval log lines
(the reference formatted bare float arrays; rectpu's training loop logs
named metrics, so the formatter is keyed).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

_ROOT_NAME = "rectpu_torch"
_CONSOLE_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s :: %(message)s"
_DATE_FMT = "%H:%M:%S"
_FILE_FMT = "%(asctime)s %(levelname)s %(process)d %(name)s :: %(message)s"

_configured = False


def configure(
    log_file: str | None = None,
    console_level: int = logging.INFO,
    file_level: int = logging.DEBUG,
    max_file_bytes: int = 10 * 1024 * 1024,
    backups: int = 1,
) -> logging.Logger:
    """(Re)configure the rectpu_torch package-root logger.

    Safe to call multiple times — handlers are rebuilt, never duplicated.
    With ``log_file`` set, a rotating file captures everything at
    ``file_level`` while the console shows ``console_level`` and above.
    """
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(min(console_level, file_level) if log_file else console_level)
    root.handlers.clear()

    console = logging.StreamHandler(stream=sys.stderr)
    console.setLevel(console_level)
    console.setFormatter(logging.Formatter(_CONSOLE_FMT, datefmt=_DATE_FMT))
    root.addHandler(console)

    if log_file:
        parent = os.path.dirname(log_file)
        if parent:
            os.makedirs(parent, exist_ok=True)
        rotating = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_file_bytes, backupCount=backups
        )
        rotating.setLevel(file_level)
        rotating.setFormatter(logging.Formatter(_FILE_FMT))
        root.addHandler(rotating)

    _configured = True
    return root


def get_logger(name: str, log_path: str | None = None, console: bool = True) -> logging.Logger:
    """Return a logger in the rectpu_torch namespace.

    ``name`` is typically ``__name__``; anything outside the ``rectpu_torch``
    package (scripts, ``__main__``) is parented under it so one root
    configuration governs all output. ``log_path`` forwards to
    :func:`configure` for entry points that want a debug file.
    """
    if log_path is not None:
        configure(log_file=log_path, console_level=logging.INFO if console else logging.ERROR)
    elif not _configured:
        configure()
    if name == "__main__":
        prog = os.path.basename(sys.argv[0] or "script")
        name = prog.rsplit(".", 1)[0] or "main"
    if name != _ROOT_NAME and not name.startswith(_ROOT_NAME + "."):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)


def fmt_metrics(metrics: dict, precision: int = 4) -> str:
    """Render ``{"loss": 0.51, "auc": 0.7612}`` as ``loss=0.5100 auc=0.7612``.

    Non-float values pass through ``str``; nested sequences of floats render
    element-wise at the same precision.
    """
    parts = []
    for key, value in metrics.items():
        parts.append(f"{key}={_fmt_value(value, precision)}")
    return " ".join(parts)


def fmt_floats(values, precision: int = 4) -> str:
    """Render an iterable of numbers at fixed precision: ``[0.1000, 0.2000]``."""
    inner = ", ".join(_fmt_value(v, precision) for v in values)
    return f"[{inner}]"


def _fmt_value(value, precision: int) -> str:
    if isinstance(value, float):
        return f"{value:.{precision}f}"
    if isinstance(value, (list, tuple)):
        return fmt_floats(value, precision)
    try:  # numpy / torch scalars
        return f"{float(value):.{precision}f}"
    except (TypeError, ValueError):
        return str(value)
