"""Build-once helper for the port's native code (host C++ and CUDA).

Each shared library is compiled from the sources in the checkout, at first
use, into ``_build/`` (gitignored), under a name keyed by a hash of the
sources and the full compiler command. A changed source or flag therefore
gets a fresh build; an unchanged one is loaded as it is. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")


def build_shared_library(name: str, sources, command,
                         libs=()) -> tuple[str, str]:
    """Compile ``sources`` with ``command`` (the compiler and its flags,
    without ``-o`` and the source list) into ``BUILD_DIR``, linking
    ``libs`` after the sources.

    Returns ``(path to the .so, compiler output)``; the output is empty when
    the library was already built."""
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update("\0".join([*command, *libs]).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.isfile(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a unique temp name and rename into place, so a concurrent
    # first use never loads a half-written library
    tmp = "{}.{}.tmp".format(so, os.getpid())
    try:
        proc = subprocess.run([*command, "-o", tmp, *sources, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building {} failed ({}):\n{}{}".format(
                name, " ".join(command), proc.stdout, proc.stderr))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, proc.stdout + proc.stderr
