"""Source trees for comparing kernel versions in one run on the card.

    python scripts/ab_trees.py [REV]

Writes under ``build/ab/`` (ignored by git, so it is copied with the
working tree), each a copy of this tree's ``src/`` with this tree's
``chip_smoke.py`` beside it:

- ``parent/``: the two redesigned kernel sources,
  ``kernels/csrc/rtree_knn.cu`` and ``kernels/csrc/rtree_select.cu``, as
  they are at REV (default: HEAD when this tree changes them, else
  HEAD~), so the kernels before the change run behind this tree's
  wrappers and script (the C entry points are the same);
- ``plain-stores/``: the score kernel's streaming stores (``__stcs`` in
  ``rtree_knn.cu``) made plain stores;
- ``four-slots-ahead/``: the score kernel's id batch (``kSlotBatch``)
  raised from 1 to 4: each thread loads the ids of its next four slots
  together;
- ``stage-64k/``: the emit kernels' staging budget (``kStageBytes``)
  doubled from 32 KB to 64 KB a block;
- ``emit-regs-free/``: the emit kernels' register bound lifted
  (``kRowBlocks`` 1: the compiler picks the registers, four blocks an
  SM where it took 56);
- ``emit-5-blocks/``: the emit kernels' register bound for five blocks an
  SM (``kRowBlocks`` 5, 51 registers a thread) instead of six;
- ``b11-tile-64/``, ``b11-tile-256/``: B11's tile (``kD3Tile`` in
  ``rtree_select.cu``) of 64 or 256 frontier slots instead of 128.

Run them in turns with this tree in one call, so that every version meets
the same card:

    for d in build/ab/parent . build/ab/stage-64k . build/ab/parent
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
CSRC = pathlib.Path("src/repro_torch/kernels/csrc")
KNN_CU = CSRC / "rtree_knn.cu"
SELECT_CU = CSRC / "rtree_select.cu"


def git(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(["git", *args], cwd=ROOT, check=False,
                          capture_output=True)


def default_rev() -> str:
    """HEAD while this tree's kernel sources differ from it, else HEAD~."""
    changed = git("diff", "--quiet", "HEAD", "--", str(KNN_CU),
                  str(SELECT_CU)).returncode != 0
    return "HEAD" if changed else "HEAD~"


def tree(name: str) -> pathlib.Path:
    """A fresh copy of this tree's ``src/`` and ``chip_smoke.py``."""
    d = AB / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copy2(ROOT / "chip_smoke.py", d)
    shutil.copytree(ROOT / "src", d / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return d


def main(rev: str | None = None) -> None:
    rev = rev or default_rev()
    parent = tree("parent")
    for cu in (KNN_CU, SELECT_CU):
        shown = git("show", f"{rev}:{cu}")
        if shown.returncode != 0:
            sys.exit(f"git show {rev}:{cu} failed: "
                     f"{shown.stderr.decode().strip()}")
        (parent / cu).write_bytes(shown.stdout)
    variant("plain-stores", r"__stcs\(([^,]+), (.+)\);", r"*\1 = \2;", 2)
    variant("four-slots-ahead", r"kSlotBatch = 1;", "kSlotBatch = 4;", 1)
    variant("stage-64k", r"kStageBytes = 32 \* 1024;",
            "kStageBytes = 64 * 1024;", 1)
    variant("emit-regs-free", r"kRowBlocks = 6;", "kRowBlocks = 1;", 1)
    variant("emit-5-blocks", r"kRowBlocks = 6;", "kRowBlocks = 5;", 1)
    for tile in (64, 256):
        variant(f"b11-tile-{tile}", r"kD3Tile = 128;", f"kD3Tile = {tile};",
                1, SELECT_CU)
    print(f"wrote {parent} (kernel sources at {rev}) and the variants in "
          f"{AB}")


def variant(name: str, pattern: str, repl: str, count: int,
            cu: pathlib.Path = KNN_CU) -> None:
    """This tree's ``src/`` with ``pattern`` (``count`` times) replaced in
    the kernel source ``cu``."""
    d = tree(name)
    text, n = re.subn(pattern, repl, (d / cu).read_text())
    if n != count:
        sys.exit(f"{name}: expected {count} of {pattern!r} in {cu}, "
                 f"found {n}")
    (d / cu).write_text(text)


if __name__ == "__main__":
    main(*sys.argv[1:])
