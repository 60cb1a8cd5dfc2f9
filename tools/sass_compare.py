"""Compare the SASS of two builds of the port's kernel library, function by function.

    python tools/sass_compare.py LIB_A LIB_B [NAME_SUBSTRING]

Runs `cuobjdump -sass` (the CUDA toolkit's) on each shared library,
splits each listing into its functions and normalises every instruction
(the text between its address and its `;`: no addresses, no encodings).
For each function of B whose mangled name holds NAME_SUBSTRING it prints
one JSON line: its instruction count in B, the function of A it is held
to and that one's count, and whether the two instruction streams are
equal. Names are compared without their anonymous namespace (nvcc names
it after the source file's path and a hash, which differ between two
checkouts); a function of B is matched in A by its name, else by its
name without the template's last `bool` argument (`Lb0E`, `Lb1E`), else,
for a function template whose one argument is a `bool` (`ILb0EEEv`), by the
name of the plain function it was: a kernel that gained a template flag is
held to what it was. Needs a CUDA
toolkit (cuobjdump on PATH or under /usr/local/cuda/bin); no card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                 "cuobjdump")


def plain_name(name: str) -> str:
    """The mangled name without its anonymous namespace's path and hash."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN<anon>", name)


def functions(lib: str) -> dict:
    """{mangled name without the anonymous namespace: [normalised
    instruction, ...]} of the library's SASS."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            name = plain_name(hit.group(1))
            funcs[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and ins:
            funcs[name].append(" ".join(ins.group(1).split()))
    return funcs


def main():
    lib_a, lib_b = sys.argv[1], sys.argv[2]
    key = sys.argv[3] if len(sys.argv) > 3 else ""
    fa, fb = functions(lib_a), functions(lib_b)
    for name, body in sorted(fb.items()):
        if key not in name:
            continue
        old = next((c for c in (name, re.sub(r"ILb[01]EEEv", "E", name, count=1),
                                re.sub(r"Lb[01]E(?=E)", "", name, count=1)) if c in fa), name)
        other = fa.get(old)
        print(json.dumps({"function": name, "instructions": len(body),
                          "held_to": old if other is not None else None,
                          "held_to_instructions": None if other is None else len(other),
                          "equal": other == body}), flush=True)


if __name__ == "__main__":
    main()
