"""Alerts (C5 §II-B2): detect 'abnormal or toxic' entries at ingest time.

Alert rules are policy criteria checked against every entry as it flows into
the catalog (entry hook) — no scan. Matching entries trigger a configurable
action: append to an alert log file, collect in memory, or call back.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from .policy import Expr, parse_expr
from .telemetry import MetricRegistry
from .types import Entry


class AlertRule:
    def __init__(self, name: str, criteria: str,
                 action: Optional[Callable[[str, Entry], None]] = None,
                 cooldown: float = 0.0) -> None:
        self.name = name
        self.expr: Expr = parse_expr(criteria)
        self.action = action
        self.cooldown = cooldown          # per-fid re-alert suppression
        self._last_fired = {}

    def check(self, e: Entry, now: float) -> bool:
        if not self.expr.evaluate(e, now):
            return False
        last = self._last_fired.get(e.fid, 0.0)
        if self.cooldown and now - last < self.cooldown:
            return False
        self._last_fired[e.fid] = now
        return True


class AlertManager:
    """Ingest-time alert fan-out.

    The alert log is held open across fired alerts (lazy first-open,
    flushed per record so a tail sees alerts immediately) instead of
    reopened per alert — an ingest storm tripping a rule no longer pays
    an open/close syscall pair per record. Use :meth:`close` (or the
    context-manager form) to release the handle; firing after close
    reopens it. ``telemetry=`` (or :meth:`bind_telemetry`) additionally
    counts fired alerts per rule as ``alerts_fired{rule=...}``.
    """

    def __init__(self, log_path: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 telemetry: Optional[MetricRegistry] = None) -> None:
        self.rules: List[AlertRule] = []
        self.fired: List[dict] = []
        self.log_path = log_path
        self.clock = clock
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._fh = None

    def bind_telemetry(self, registry: MetricRegistry) -> "AlertManager":
        self.telemetry = registry
        return self

    def add_rule(self, rule: AlertRule) -> None:
        self.rules.append(rule)

    def _log_handle(self):
        # lock held; lazy so a manager that never fires (or logs only in
        # memory) never touches the filesystem
        if self._fh is None and self.log_path:
            self._fh = open(self.log_path, "a", encoding="utf-8")
        return self._fh

    def close(self) -> None:
        """Release the alert-log handle (idempotent; fires reopen it)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "AlertManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def on_entry(self, e: Entry) -> None:
        """Wire as ``catalog.add_entry_hook(mgr.on_entry)``."""
        now = self.clock()
        for rule in self.rules:
            if rule.check(e, now):
                rec = {"alert": rule.name, "fid": e.fid, "path": e.path,
                       "owner": e.owner, "size": e.size, "time": now}
                with self._lock:
                    self.fired.append(rec)
                    fh = self._log_handle()
                    if fh is not None:
                        fh.write(f"{now:.3f} ALERT {rule.name} "
                                 f"path={e.path} owner={e.owner} "
                                 f"size={e.size}\n")
                        fh.flush()        # a tail -f sees the alert now
                if self.telemetry is not None:
                    self.telemetry.counter(
                        "alerts_fired", help="ingest alerts fired per rule",
                        rule=rule.name).inc()
                if rule.action is not None:
                    rule.action(rule.name, e)
