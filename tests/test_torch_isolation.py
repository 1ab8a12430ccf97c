"""guetzli_tpu_torch stands alone: it imports neither jax nor any module of
the JAX package guetzli_tpu (nor does chip_smoke.py, the port's smoke run
on the card), and its CUDA kernels are built lazily from sources in the
package (so the wrappers import on a machine without nvcc).
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

import guetzli_tpu_torch
from guetzli_tpu_torch.kernels import build, tables

PKG = pathlib.Path(guetzli_tpu_torch.__file__).parent
REPO = PKG.parent


def _forbidden(name):
    """jax, jaxlib, and the JAX package (a module-name check: the port's
    own name starts with the string 'guetzli_tpu')."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "guetzli_tpu"


def test_forbidden_is_a_module_name_check():
    assert _forbidden("guetzli_tpu") and _forbidden("guetzli_tpu.consts")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("guetzli_tpu_torch")
    assert not _forbidden("guetzli_tpu_torch.ops.image")


def test_ast_scan_finds_no_forbidden_import():
    bad = []
    paths = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) > 20
    for path in paths:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += ["%s: %s" % (path.name, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_ast_scan_covers_the_corpus_modules():
    """The lockstep encoder, the runtime and the corpus CLI are among the
    scanned files, and none of them imports jax or the JAX package."""
    scanned = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"parallel/lockstep.py", "runtime/__init__.py",
            "corpus_cli.py"} <= scanned
    for rel in ("parallel/lockstep.py", "runtime/__init__.py",
                "corpus_cli.py"):
        tree = ast.parse((PKG / rel).read_text())
        mods = [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)]
        mods += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        assert not [m for m in mods if _forbidden(m or "")], (rel, mods)


_CHILD = r"""
import importlib, pkgutil, sys
import guetzli_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(guetzli_tpu_torch.__path__,
                                              "guetzli_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from guetzli_tpu_torch.io.png import read_png
import numpy as np
rgb, w, h = read_png(open(sys.argv[1], "rb").read())
sub = np.ascontiguousarray(rgb[:40, :40])
from guetzli_tpu_torch import consts
from guetzli_tpu_torch.search.processor import Params, process_rgb
p = Params()
p.butteraugli_target = consts.butteraugli_score_for_quality(95)
out = process_rgb(p, sub, 40, 40, None, "cpu")
assert out[:2] == b"\xff\xd8"
from guetzli_tpu_torch import api
from guetzli_tpu_torch.codec import reader
out = api.encode_bytes(open(sys.argv[2], "rb").read(), 95, device="cpu")
assert reader.read_jpeg(out).is_420()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "guetzli_tpu")]
print("MODULES", len(mods), "BAD", bad)
"""


def test_subprocess_imports_and_encodes_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", _CHILD,
         str(REPO / "tests" / "fixtures" / "bees96x64.png"),
         str(REPO / "tests" / "corpus" / "bees_d-420.jpg")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MODULES")]
    assert line and line[0].endswith("BAD []"), r.stdout
    assert int(line[0].split()[1]) >= 20


def test_kernel_sources_listed_and_present():
    for name, src in build.SOURCES.items():
        text = (build.CSRC / src).read_text()
        assert '#include "compare_block.cuh"' in text
        assert "extern \"C\" int gt_%s(" % name in text
        assert name in build.SIGNATURES
    for name, (lib, fname, argtypes) in build.SIGNATURES.items():
        text = (build.CSRC / build.SOURCES[lib]).read_text()
        assert "extern \"C\" int %s(" % fname in text
        # Every C parameter is one ctypes argument.
        decl = text[text.index("int %s(" % fname):]
        decl = decl[:decl.index(")")]
        assert decl.count(",") + 1 == len(argtypes), name
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    for mod in (ka, zl):
        assert set(mod.ENTRY) == set(mod.launches) == {"444", "420y",
                                                       "420c"}
        assert set(mod.ENTRY.values()) <= set(build.SIGNATURES)
    for h in build.HEADERS:
        assert (build.CSRC / h).exists()
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(p.name for p in build.CSRC.iterdir()) == \
        set(build.SOURCES.values()) | set(build.HEADERS)


def test_table_layout_matches_cuda_header():
    """The offsets tables.py writes are the #defines the kernel reads."""
    text = (build.CSRC / "compare_block.cuh").read_text()
    defines = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"#define ([TSN]_\w+) (\d+)", text)}
    for name, (off, _len) in tables.LAYOUT.items():
        assert defines[name] == off, name
    for name, off in tables.SCALARS.items():
        assert defines[name] == off, name
    assert defines["N_TABLES"] == tables.N_TABLES
    buf = tables.build(torch.device("cpu"))
    assert buf.shape == (tables.N_TABLES,) and buf.dtype == torch.float32
    start, n = tables.LAYOUT["T_SCAL"]
    assert start + n <= tables.N_TABLES


def test_build_is_lazy(monkeypatch):
    """Importing and calling the wrappers on CPU tensors needs no nvcc;
    asking for a build without nvcc raises instead of falling back."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


@pytest.mark.gpu
def test_kernels_on_card():
    """Every compare kernel (A, A', A'', C) against its plain version and
    every greedy kernel (B, B', B'') against the staged loop, on the card,
    at bees96x64 sizes (chip_smoke.py runs them at full size); kernel C
    also against A, and the staged loop with C (mode 444p) against B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import numpy as np
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.ops import tiles_lanes as tl
    from guetzli_tpu_torch.search import state as st
    from guetzli_tpu_torch.search import zeroing
    from guetzli_tpu_torch.search.processor import Params, Processor
    dev = torch.device("cuda")
    rgb, w, h = read_png((REPO / "tests/fixtures/bees96x64.png").read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h, quant=np.full((3, 64), 5, np.int32))
    comp = Comparator(rgb, w, h, 1.0, dev)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    passes = [(img, 7)]
    img420 = img.copy()
    img420.downsample()
    passes += [(img420, 1), (img420, 6)]
    proc = Processor(Params(), comp, None)
    for im, mask in passes:
        grid = im.comps[mask.bit_length() - 1]
        mode, aux = proc.masking_aux(im, mask, grid)
        cand = np.zeros((grid.bw * grid.bh, 3, 64), np.int32)
        for c in range(3):
            if (mask >> c) & 1:
                cand[:, c] = im.comps[c].coeffs
        lanes = tl.LANE_AUX[mode](*aux)
        ct = torch.as_tensor(cand, device=dev).reshape(-1, 3, 8, 8) \
            .permute(1, 2, 3, 0).contiguous()
        k = ka.tile_compare_lanes(ct, *lanes, mode=mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, tl.COMPARE[mode](ct, *lanes),
                                   rtol=1e-5, atol=0)
        a = zeroing.compute_zeroing_csr(cand, cand, np.float32(2.5), aux,
                                        mask, dev, mode=mode, fused=True)
        b = zeroing.compute_zeroing_csr(cand, cand, np.float32(2.5), aux,
                                        mask, dev, mode=mode, fused=False)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        if mode != "444":
            continue
        x0, sc, ysel, xsel = aux
        sy, sx = kc.selection_matrices(ysel, xsel)
        args = (torch.as_tensor(cand, device=dev), x0.contiguous(), sc, sy,
                sx)
        before = kc.launches
        c = kc.tile_compare(*args)
        torch.cuda.synchronize()
        assert kc.launches == before + 1
        assert torch.equal(c, kc.tile_compare_plain(*args))
        assert torch.equal(c, k)
        p = zeroing.compute_zeroing_csr(cand, cand, np.float32(2.5),
                                        (x0, sc, sy, sx), mask, dev,
                                        mode="444p")
        for x, y in zip(a, p):
            np.testing.assert_array_equal(x, y)
