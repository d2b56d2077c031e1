"""Live log-level reload from the ``config-logging`` ConfigMap.

Reference: cmd/controller/main.go:105-117 — the logging context is built
from the ``config-logging`` ConfigMap and the level is live-reloaded on
ConfigMap change (knative's UpdateLevelFromConfigMap); cmd/webhook/main.go
:84-92 validates the same map. Data format follows knative's:

- ``zap-logger-config``: JSON whose ``level`` field sets the root
  ``karpenter`` logger ("debug" | "info" | "warn" | "error");
- ``loglevel.<component>``: per-component override, applied to
  ``karpenter.<component>`` (e.g. ``loglevel.solver: debug``).
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound

log = logging.getLogger("karpenter.logging-config")

CONFIG_MAP_NAME = "config-logging"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def _zap_level(raw: str):
    """Parse zap-logger-config JSON → (level or None, error or None)."""
    try:
        cfg = json.loads(raw)
    except ValueError as e:
        return None, f"zap-logger-config: invalid JSON: {e}"
    if not isinstance(cfg, dict):
        return None, "zap-logger-config: must be a JSON object"
    level = cfg.get("level")
    if level is not None and level not in _LEVELS:
        return None, f"zap-logger-config: unknown level {level!r}"
    return level, None


def validate_config(data: dict) -> Optional[str]:
    """Webhook-side validation of the map (cmd/webhook/main.go:84-92)."""
    raw = data.get("zap-logger-config")
    if raw is not None:
        _, err = _zap_level(raw)
        if err is not None:
            return err
    for key, value in data.items():
        if key.startswith("loglevel.") and value not in _LEVELS:
            return f"{key}: unknown level {value!r}"
    return None


class LoggingConfigController:
    """Applies the config on every ConfigMap reconcile."""

    def __init__(self, kube: KubeCore, namespace: str = "default",
                 root_logger: str = "karpenter"):
        self.kube = kube
        self.namespace = namespace
        self.root_logger = root_logger

    def kind(self) -> str:
        return "ConfigMap"

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        # only the controller's own namespace may configure logging: any
        # tenant could otherwise create a config-logging map and flip levels
        if name != CONFIG_MAP_NAME or namespace != self.namespace:
            return None
        try:
            cm = self.kube.get("ConfigMap", name, namespace)
        except NotFound:
            return None
        err = validate_config(cm.data)
        if err is not None:
            log.error("ignoring %s: %s", CONFIG_MAP_NAME, err)
            return None
        raw = cm.data.get("zap-logger-config")
        if raw:
            level, _ = _zap_level(raw)
            if level:
                logging.getLogger(self.root_logger).setLevel(_LEVELS[level])
                log.info("root log level set to %s", level)
        for key, value in cm.data.items():
            if key.startswith("loglevel."):
                component = key[len("loglevel."):]
                logging.getLogger(f"{self.root_logger}.{component}").setLevel(_LEVELS[value])
                log.info("%s log level set to %s", component, value)
        return None
