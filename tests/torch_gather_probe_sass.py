"""The instructions of kernel gather_probe's gather loops, read from the
SASS of a CUDA source, on a machine with nvcc and cuobjdump (no card is
needed):

    python3 tests/torch_gather_probe_sass.py [--source PATH] [--out FILE]

Compiles PATH (default: this checkout's
``zeldaengine_tpu_torch/csrc/gather_probe.cu``; an older checkout's source
gives the kernel before a change) with the package's nvcc flags
(``ops/_build.py``, sm_90a) into an object file, dumps its SASS with
``cuobjdump -sass`` and prints one JSON line: for each instantiation of
``gather_probe_kernel``, its gather loop as
``tools/gather_probe.py::kernel_sass`` reads it (opcode counts,
instructions, LDS, FADD, instructions a gather). ``--out`` also keeps
the whole SASS listing. Not collected by pytest.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from zeldaengine_tpu_torch.ops import _build  # noqa: E402
from zeldaengine_tpu_torch.tools import gather_probe  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_gather_probe_sass")
    parser.add_argument("--source", default=str(
        HERE / "zeldaengine_tpu_torch" / "csrc" / "gather_probe.cu"))
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "gather_probe.o"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                        args.source, "-o", str(obj)], check=True)
        loops = gather_probe.kernel_sass(obj, keep=args.out)
    print(json.dumps({"source": args.source, "loops": loops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
