"""Whether two versions of a kernel source compile to the same machine code.

Compiles ``src/repro_torch/kernels/csrc/<name>.cu`` of two checkouts with
the flags of ``kernels/_build.py`` into cubins, disassembles each with
``cuobjdump -sass`` and prints, for every kernel instantiation, whether its
SASS is the same in both (the instantiations are matched by their
demangled names and template arguments, a trailing argument that only
names an output type equal to the input type dropped, so that a default
template argument added in one version still matches; branch labels
numbered within each function). Needs ``nvcc``, ``cuobjdump`` and
``cu++filt`` (the CUDA toolkit); run it where the card is:

    python tools/sass_compare.py OLD_CHECKOUT NEW_CHECKOUT dot_interaction

A fourth argument prints the SASS diff of each instantiation whose name
contains it (for example ``"<float, (int)64, (bool)1>"``).
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
TOOLS = Path("/usr/local/cuda/bin")


def sass(checkout: Path, name: str, work: Path) -> dict[str, str]:
    """{demangled kernel name: its SASS without addresses} of one build."""
    cubin = work / f"{checkout.name}-{name}.cubin"
    src = checkout / "src/repro_torch/kernels/csrc" / f"{name}.cu"
    subprocess.run([str(TOOLS / "nvcc"), *FLAGS, "-cubin", "-o", str(cubin),
                    str(src)], check=True)
    text = subprocess.run([str(TOOLS / "cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        mangled, body = block.split("\n", 1)
        pretty = subprocess.run([str(TOOLS / "cu++filt"), mangled.strip()],
                                check=True, capture_output=True,
                                text=True).stdout.strip()
        # the name and template arguments, without the parameter list
        # (whose types a version may spell as template parameters); a
        # trailing output-type argument equal to the first one (the default
        # a later version may add) does not tell kernels apart
        pretty = pretty.split(">(")[0] + ">"
        pretty = re.sub(r"<(float|__nv_bfloat16), (.*), \1>$", r"<\1, \2>",
                        pretty)
        lines = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
                 for line in body.splitlines()
                 if line.strip().startswith("/*")]
        # branch labels are numbered across the whole cubin: number them
        # within the function
        labels: dict[str, str] = {}
        out[pretty] = re.sub(
            r"\.L_x_\d+",
            lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"),
            "\n".join(lines))
    return out


def main() -> int:
    old, new, name = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = sass(old, name, Path(tmp)), sass(new, name, Path(tmp))
    for kernel in sorted(set(a) | set(b)):
        if kernel not in a or kernel not in b:
            state = "only in " + ("new" if kernel in b else "old")
        else:
            state = "same SASS" if a[kernel] == b[kernel] else "SASS differs"
        print(f"{state}: {kernel}")
        if len(sys.argv) > 4 and sys.argv[4] in kernel and \
                state == "SASS differs":
            sys.stdout.writelines(difflib.unified_diff(
                a[kernel].splitlines(True), b[kernel].splitlines(True),
                "old", "new", n=1))
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
