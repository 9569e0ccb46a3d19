"""Compare the machine code of one kernel source in two trees.

    python -m project_morpheus_tpu_torch.tools.sass_compare OTHER_CSRC [SOURCE]

Builds ``SOURCE`` (default ``prefill_chunk_attention.cu``) from this
package's ``ops/csrc`` and from ``OTHER_CSRC`` (the ``ops/csrc`` of another
tree, for example a ``git archive`` of a parent commit) with the flags of
``ops/build.py``, disassembles both with ``cuobjdump -sass`` and prints, for
each kernel, its instruction count in each and whether the instructions are
the same once addresses, encodings and the file's hash in the kernel's name
are left out (a template flag added as ``false`` is left out of the name
too, so an instantiation keeps its name across such a change).  Needs the
CUDA toolkit (the card's machine has it).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

from project_morpheus_tpu_torch.ops import build


def kernels(sass: str) -> Dict[str, List[str]]:
    """kernel name (its anonymous namespace's hash left out) -> its
    instructions, addresses and encodings left out."""
    out: Dict[str, List[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # a template flag added as false (Lb0E) names the kernel it was before
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "", m.group(1))
            cur = cur.replace("Lb0E", "")
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if cur is not None and m:
            out[cur].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return out


def disassemble(csrc: Path, source: str, workdir: Path) -> Dict[str, List[str]]:
    nvcc = build._nvcc()
    lib = workdir / f"{csrc.parent.name}-{Path(source).stem}-{os.getpid()}.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(csrc / source)], check=True,
                   capture_output=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    return kernels(subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                                  capture_output=True, text=True).stdout)


def main(argv) -> None:
    other = Path(argv[0]).resolve()
    source = argv[1] if len(argv) > 1 else "prefill_chunk_attention.cu"
    with tempfile.TemporaryDirectory() as tmp:
        theirs = disassemble(other, source, Path(tmp))
        ours = disassemble(build.CSRC, source, Path(tmp))
    for name in sorted(set(ours) | set(theirs)):
        if name not in ours or name not in theirs:
            print(f"{name}: only in {'this tree' if name in ours else other}", flush=True)
            continue
        a, b = theirs[name], ours[name]
        print(f"{name}: {len(a)} instructions there, {len(b)} here, "
              f"{'identical' if a == b else 'different'}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
