"""Hypothesis keeps its example database and its caches (which it
rewrites on every run) under ``.hypothesis/run/``, which git ignores,
unless ``HYPOTHESIS_STORAGE_DIRECTORY`` is set already; so a test run
leaves the tracked files under ``.hypothesis/`` as they are."""

import os
from pathlib import Path

os.environ.setdefault("HYPOTHESIS_STORAGE_DIRECTORY",
                      str(Path(__file__).resolve().parent / ".hypothesis" / "run"))
