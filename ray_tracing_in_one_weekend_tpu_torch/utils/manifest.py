"""The render manifest: what made each written image.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/manifest.py,
with the same API (`RENDER_SOURCES`, `render_sources_digest`, `load`,
`record`). Each image a gallery script writes gets an entry in
`MANIFEST.json` beside it: the render's settings and times, the digest of
the sources that decide its pixels, and where it was made (the git commit,
marked `-dirty` when the tree had changes; the Python, torch and CUDA
versions; the card's name and power limit). A later change to those
sources shows as a digest that no longer matches the image's.

The digest covers exactly the files whose code decides a pixel: the
kernel and its device functions, the build flags (`-fmad=false` decides
the bits), the plain version, scene and camera construction, the fold of
sample batches, the presets and the 8-bit quantization. Scheduling alone
(tile, passes, budget, the warm cache) changes no pixel, but lives in
`ops/cuda_render.py` with the plain version, so a change there asks for a
new render all the same.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys

_PKG = "ray_tracing_in_one_weekend_tpu_torch"

# Files whose content decides rendered pixel values, relative to the repo
# root.
RENDER_SOURCES = (
    f"{_PKG}/ops/cuda_render.py",
    f"{_PKG}/ops/vecmath.py",
    f"{_PKG}/ops/image.py",
    f"{_PKG}/models/scene.py",
    f"{_PKG}/models/camera.py",
    f"{_PKG}/utils/checkpoint.py",
    f"{_PKG}/utils/config.py",
    f"{_PKG}/kernels/build.py",
    f"{_PKG}/csrc/render_kernel.cu",
    f"{_PKG}/csrc/render_device.cuh",
)

MANIFEST_NAME = "MANIFEST.json"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    """Remove docstring expressions so the digest tracks code."""
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (
            isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            node.body = body[1:] or [ast.Pass()]
    return tree


def render_sources_digest(root: str | None = None) -> str:
    """sha256 over the render-deciding sources under `root` (default: this
    checkout).

    A Python file counts by its docstring-stripped, re-unparsed AST, as the
    JAX package's digest does: comments and docstrings change no pixel and
    ask for no new render, while any change to code, a constant included,
    changes the digest (`ast.unparse`, not `ast.dump`, whose fields change
    across Python minor versions). A CUDA file counts by its bytes."""
    root = root or repo_root()
    h = hashlib.sha256()
    for rel in RENDER_SOURCES:
        h.update(rel.encode())
        with open(os.path.join(root, rel), "rb") as f:
            data = f.read()
        if rel.endswith(".py"):
            data = ast.unparse(_strip_docstrings(ast.parse(data))).encode()
        h.update(data)
    return h.hexdigest()


def _git(root: str, *args: str) -> str | None:
    """The stripped output of `git <args>` in `root`, or None when git
    fails or is missing."""
    try:
        out = subprocess.run(["git", *args], cwd=root, capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def git_commit(root: str | None = None) -> str:
    """HEAD's hash, with `-dirty` appended when tracked files differ from
    it; "unknown" when `root` is not the top of a git checkout (a `git
    archive` unpacked inside another checkout included)."""
    root = os.path.realpath(root or repo_root())
    top = _git(root, "rev-parse", "--show-toplevel")
    head = _git(root, "rev-parse", "HEAD")
    if top is None or head is None or os.path.realpath(top) != root:
        return "unknown"
    changes = _git(root, "status", "--porcelain", "--untracked-files=no")
    return head + ("-dirty" if changes else "")


def provenance(device: str) -> dict:
    """Where a render ran: the Python, torch and CUDA versions, and the card
    (nvidia-smi's name and power limit) or "cpu"."""
    import torch

    card = "cpu"
    if str(device).startswith("cuda"):
        from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi

        card = nvidia_smi()
    return {
        "python_version": "%d.%d" % sys.version_info[:2],
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "card": card,
    }


def load(gallery_dir: str) -> dict:
    path = os.path.join(gallery_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def record(gallery_dir: str, artifact: str, info: dict, device: str = "cuda") -> dict:
    """Record `artifact` (a file name in `gallery_dir`), rendered on
    `device`, with its render settings `info`, the sources digest and the
    provenance; returns the entry."""
    root = repo_root()
    m = load(gallery_dir)
    m[artifact] = entry = {
        **info,
        "render_sources_digest": render_sources_digest(root),
        "git_commit": git_commit(root),
        **provenance(device),
    }
    with open(os.path.join(gallery_dir, MANIFEST_NAME), "w") as f:
        json.dump(m, f, indent=2, sort_keys=True)
        f.write("\n")
    return entry
