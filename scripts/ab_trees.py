"""Source trees for comparing kernel versions in one run on the card.

    python scripts/ab_trees.py [REV]

Writes under ``build/ab/`` (ignored by git, so it is copied with the
working tree), each with this tree's ``chip_smoke.py`` beside its ``src/``:

- ``parent/``: ``git archive REV src`` (default HEAD), the kernels before
  the change;
- ``plain-stores/``: this tree's ``src/`` with the score kernel's streaming
  stores (``__stcs`` in ``kernels/csrc/rtree_knn.cu``) made plain stores;
- ``four-slots-ahead/``: this tree's ``src/`` with the score kernel's id
  batch (``kSlotBatch``) raised from 1 to 4: each thread loads the ids of
  its next four slots together.

Run them in turns with this tree in one call, so that every version meets
the same card:

    for d in build/ab/parent . build/ab/four-slots-ahead . build/ab/parent
    do (cd $d && python3 chip_smoke.py); done
"""
from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
AB = ROOT / "build" / "ab"
KNN_CU = pathlib.Path("src/repro_torch/kernels/csrc/rtree_knn.cu")


def fresh(name: str) -> pathlib.Path:
    d = AB / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copy2(ROOT / "chip_smoke.py", d)
    return d


def main(rev: str = "HEAD") -> None:
    parent = fresh("parent")
    archive = subprocess.run(["git", "archive", rev, "src"], cwd=ROOT,
                             check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", str(parent)], input=archive,
                   check=True)
    variant("plain-stores", r"__stcs\(([^,]+), (.+)\);", r"*\1 = \2;", 2)
    variant("four-slots-ahead", r"kSlotBatch = 1;", "kSlotBatch = 4;", 1)
    print(f"wrote {parent} ({rev}), plain-stores and four-slots-ahead in "
          f"{AB}")


def variant(name: str, pattern: str, repl: str, count: int) -> None:
    """This tree's ``src/`` with ``pattern`` (``count`` times) replaced in
    the score kernel's source."""
    d = fresh(name)
    shutil.copytree(ROOT / "src", d / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    text, n = re.subn(pattern, repl, (d / KNN_CU).read_text())
    if n != count:
        sys.exit(f"{name}: expected {count} of {pattern!r} in {KNN_CU}, "
                 f"found {n}")
    (d / KNN_CU).write_text(text)


if __name__ == "__main__":
    main(*sys.argv[1:])
