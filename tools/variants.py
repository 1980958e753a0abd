"""Build variants of the port's CUDA sources, for the tools that time them
(``tools/nic_variants.py``, ``tools/window_variants.py``).

A variant is a copy of ``shadow_tpu_torch/csrc`` under the kernels' build
directory with edits to some of its files, built by nvcc with the
kernels' flags and bound with the kernel's argument types, so a tool can
put it in ``kernels._libs`` in place of the port's own library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from shadow_tpu_torch import kernels


def replace_once(src: str, edits: dict, where: str) -> str:
    """``src`` with each text of ``edits`` replaced by its value; each
    text must occur exactly once."""
    for old, new in edits.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{where} no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def variant_source(tag: str, edits: dict) -> str:
    """A copy of the sources named ``tag`` with ``edits`` made: {file:
    {text: replacement}} or {file: function of the file's text}. Returns
    its directory."""
    out = os.path.join(kernels.BUILD_DIR, "variants", tag)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(kernels.CSRC, out)
    for name, edit in edits.items():
        path = os.path.join(out, name)
        with open(path) as f:
            src = f.read()
        if callable(edit):
            src = edit(src)
        else:
            src = replace_once(src, edit, f"{tag}: {name}")
        with open(path, "w") as f:
            f.write(src)
    return out


def build(builds: dict) -> dict:
    """{(kernel, variant): library} for ``builds``, {(kernel, variant):
    edits}: a copy of the sources and one nvcc process a build, all
    started together. Prints each build's ptxas usage line; raises if a
    build fails."""
    by_name = {k.name: k for k in kernels.KERNELS}
    procs = {}
    for (name, v), edits in builds.items():
        src = variant_source(f"{name}-{v}", edits)
        so = os.path.join(src, f"{name}.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so,
               os.path.join(src, f"{name}.cu")]
        procs[(name, v)] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for (name, v), (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {v}:\n{log}")
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"ptxas {name} {v}: {' | '.join(usage)}", flush=True)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, name)
        fn.argtypes = list(by_name[name].argtypes)
        fn.restype = ctypes.c_int
        libs[(name, v)] = lib
    return libs
