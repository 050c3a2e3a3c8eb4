#!/usr/bin/env python3
"""Compares the SASS of the port's kernels in two checkouts, function by
function.

    python3 tools/sass_compare.py OLD_ROOT NEW_ROOT [--only NAME ...]

Builds each checkout's kernel library with its own sources (a process
each, as kernels.build() does for that tree), dumps both with
``cuobjdump -sass`` and compares the text of every kernel, encodings
included (a run of blanks counts as one). A kernel compiled into several
objects is compared as the set of its distinct bodies; the hash of a
file-local (anonymous) namespace, which depends on the file's path, is
taken out of the names. Prints one line a kernel that differs (how many
lines differ, and the first) or is in one library only, and for a kernel
in the old library only the new-only kernel whose bodies are identical (a
template that gained parameters keeps its code under a new name), then
the counts: kernels in both, identical, differing, renamed.
--only keeps the kernels whose mangled name holds one of the NAMEs.
Needs nvcc (the card's machine); exits 1 if a build or cuobjdump fails.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from robust_object_detection_tpu_torch import kernels; "
         "print(kernels.build()); print(kernels.nvcc_path())")


def build(root: Path):
    """(library path, nvcc path) of `root`'s kernels, built there."""
    res = subprocess.run([sys.executable, "-c", BUILD, str(root)],
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise SystemExit(f"FAIL: build of {root}: {res.stderr[-2000:]}")
    so, nvcc = res.stdout.strip().splitlines()[-2:]
    return Path(so), Path(nvcc)


def functions(so: Path, nvcc: Path, only) -> dict:
    """{mangled kernel name: sorted distinct SASS bodies} of a library."""
    res = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(so)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"FAIL: cuobjdump {so}: {res.stderr[-2000:]}")
    out, fn, body = {}, None, []

    def close():
        if fn and (not only or any(n in fn for n in only)):
            out.setdefault(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                                  fn), set()).add("\n".join(body))

    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m or re.match(r"\s*(Fatbin|\.section|code for)", line):
            close()
            fn, body = (m.group(1) if m else None), []
        elif fn and line.strip().strip("."):
            body.append(" ".join(line.split()))
    close()
    return {k: sorted(v) for k, v in out.items()}


def first_difference(a: list, b: list) -> str:
    """How the first bodies differ: lengths, lines that differ, the first
    of them."""
    la, lb = a[0].splitlines(), b[0].splitlines()
    diff = [i for i, (x, y) in enumerate(zip(la, lb)) if x != y]
    head = (f"{len(a)} / {len(b)} bodies, {len(la)} / {len(lb)} lines, "
            f"{len(diff)} differ")
    if not diff:
        return head + " (equal up to the shorter)"
    i = diff[0]
    return f"{head}; line {i}: {la[i]!r} / {lb[i]!r}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--only", nargs="*", default=())
    args = ap.parse_args()
    libs = [functions(*build(r.resolve()), args.only)
            for r in (args.old, args.new)]
    old, new = libs
    same = differ = 0
    for fn in sorted(set(old) | set(new)):
        if fn not in new or fn not in old:
            print(f"[sass] only in {'old' if fn in old else 'new'}: {fn}")
        elif old[fn] == new[fn]:
            same += 1
        else:
            differ += 1
            print(f"[sass] differs: {fn}: "
                  f"{first_difference(old[fn], new[fn])}")
    # a kernel whose name changed (a template that gained parameters) is
    # matched to a new-only kernel with the same bodies
    new_only = {fn: new[fn] for fn in set(new) - set(old)}
    renamed = 0
    for fn in sorted(set(old) - set(new)):
        twins = [n for n, body in new_only.items() if body == old[fn]]
        if twins:
            renamed += 1
            print(f"[sass] renamed, identical: {fn} -> {twins[0]}")
    print(f"[sass] {len(set(old) & set(new))} kernels in both: {same} "
          f"identical, {differ} differ; {len(set(old) - set(new))} only in "
          f"old ({renamed} of them identical to a kernel only in new), "
          f"{len(set(new) - set(old))} only in new")
    return 0


if __name__ == "__main__":
    sys.exit(main())
