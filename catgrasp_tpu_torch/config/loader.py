"""YAML config loading — plain dicts (``catgrasp_tpu/config/loader.py``),
reading the port's own copies of the config files."""
from __future__ import annotations

import os

import yaml

CONFIG_DIR = os.path.dirname(os.path.realpath(__file__))


def load_config(name: str = "config_run.yml") -> dict:
    path = name if os.path.isabs(name) else os.path.join(CONFIG_DIR, name)
    with open(path) as f:
        return yaml.safe_load(f)
