"""Filesystem helpers (demo2_tpu/utils/iotools.py; reference: utils/iotools.py)."""

from __future__ import annotations

import json
import os


def mkdir_if_missing(directory: str):
    os.makedirs(directory, exist_ok=True)


def check_isfile(path: str) -> bool:
    isfile = os.path.isfile(path)
    if not isfile:
        print(f"=> Warning: no file found at '{path}' (skipped)")
    return isfile


def read_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def write_json(obj, path: str):
    mkdir_if_missing(os.path.dirname(os.path.abspath(path)))
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))
