"""The kernel library's build, without ``nvcc``: the library's name is a
digest of every file the compiler reads from ``csrc`` (the sources and
the headers they include), so an edited header never loads a stale
build; and the flash kernels' sources hold no ``mma.sync`` product (the
query-major and key-major kernels issue theirs with ``wgmma``).
"""
import re
import shutil

import pytest

from apex_tpu_torch.ops import _build

CSRC = _build.CSRC
HEADERS = sorted(p.name for p in CSRC.glob("*.cuh"))
FILES = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
FLASH = ("flash_attention.cu", "flash_attention_bwd.cu",
         "flash_attention_md.cu", "flash_attention_bwd_md.cu",
         "flash_qmajor.cuh", "flash_qmajor_ws.cuh", "flash_kmajor.cuh",
         "flash_kmajor_ws.cuh", "hopper.cuh")


def _code(text: str) -> str:
    """``text`` without its ``//`` comments."""
    return "\n".join(line.split("//", 1)[0] for line in text.splitlines())


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_the_sources_are_the_kernel_files():
    """``SOURCES`` names every ``.cu`` file under ``csrc`` (an A/B build
    of another checkout compiles its sources by these names)."""
    assert sorted(_build.SOURCES) == sorted(
        p.name for p in CSRC.glob("*.cu"))
    assert HEADERS, "the flash kernels share their Hopper helpers"


def test_digest_is_stable(csrc_copy):
    assert _build._digest() == _build._digest()


@pytest.mark.parametrize("header", HEADERS)
def test_digest_changes_when_a_header_changes(csrc_copy, header):
    before = _build._digest()
    path = csrc_copy / header
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build._digest() != before


@pytest.mark.parametrize("source", sorted(_build.SOURCES))
def test_digest_changes_when_a_source_changes(csrc_copy, source):
    before = _build._digest()
    path = csrc_copy / source
    path.write_bytes(path.read_bytes().replace(b"\n", b"\n\n", 1))
    assert _build._digest() != before


@pytest.mark.parametrize("name", FILES)
def test_every_quoted_include_is_hashed(name):
    included = re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                          (CSRC / name).read_text(), flags=re.M)
    covered = set(_build._digest_files())
    for inc in included:
        assert (CSRC / inc).is_file(), f"{name} includes missing {inc}"
        assert inc in covered, f"{name} includes {inc}, which the digest " \
                               f"does not hash"


@pytest.mark.parametrize("name", FLASH)
def test_flash_sources_issue_no_mma_sync(name):
    code = _code((CSRC / name).read_text())
    assert "mma.sync" not in code and "ldmatrix" not in code


@pytest.mark.parametrize("name", ("flash_attention.cu",
                                  "flash_attention_bwd.cu"))
def test_flash_sources_take_the_shared_template(name):
    """The forward and the split dq kernel are one template, whose
    products are wgmma's."""
    code = _code((CSRC / name).read_text())
    assert '#include "flash_qmajor.cuh"' in code
    assert re.search(r"launch_qmajor<D, (true|false), ", code)
    assert "wgmma.mma_async" in _code((CSRC / "hopper.cuh").read_text())


def test_md_one_pass_takes_the_warp_specialized_kernel(csrc_copy):
    """The one-pass backward's mask and dropout instances launch the
    warp-specialized kernel (a copying warpgroup on TMA, an mbarrier
    ring, no block-wide barrier in the loop), which the library's name
    hashes; the split dk/dv instances keep the key-major template."""
    md = _code((CSRC / "flash_attention_bwd_md.cu").read_text())
    assert '#include "flash_kmajor_ws.cuh"' in md
    assert "launch_one_pass_ws<D, MASK, DROP>" in md
    assert "launch_bwd<D, false, MASK, DROP>" in md
    assert "launch_one_pass<" not in md
    ws = _code((CSRC / "flash_kmajor_ws.cuh").read_text())
    for piece in ("tma_load(", "mbar_wait(", "reg_dealloc<", "reg_alloc<",
                  "cp.async.mbarrier.arrive", "tensor_add_f32("):
        assert piece in ws, piece
    loop = ws[ws.index("reg_alloc<kWsRegs>();"):]
    assert "__syncthreads" not in loop and "cp_async16z" not in loop
    assert "flash_kmajor_ws.cuh" in _build._digest_files()
    before = _build._digest()
    path = csrc_copy / "flash_kmajor_ws.cuh"
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._digest() != before


def _function(code: str, name: str) -> str:
    """The body of the C++ function ``name`` in ``code`` (from its name to
    its closing brace at column 0)."""
    i = code.index(f" {name}(")
    return code[i:code.index("\n}\n", i)]


def test_md_forward_takes_the_persistent_warp_specialized_kernel(csrc_copy):
    """The forward's dropout entries (#3d, #3md) launch the warp-specialized
    persistent kernel of ``flash_qmajor_ws.cuh`` (a copying thread on TMA,
    an mbarrier ring, the product warpgroups taking turns, O out by TMA
    stores, no block-wide barrier past the prologue), which the library's
    name hashes; the split dq kernel's mask and dropout instances (#5md)
    and the forward's without dropout (#3, #3m) keep the query-major
    template."""
    md = _code((CSRC / "flash_attention_md.cu").read_text())
    assert '#include "flash_qmajor_ws.cuh"' in md
    fwd = _function(md, "fwd_drop")
    assert "launch_fwd_ws<D, MASK>" in fwd
    assert "launch_qmajor<" not in fwd
    assert "launch_qmajor<D, true, kDqBK, MASK, DROP>" in _function(md,
                                                                    "dq_md")
    plain = _code((CSRC / "flash_attention.cu").read_text())
    assert re.search(r"launch_qmajor<D, false, ", plain)
    assert "launch_fwd_ws" not in plain
    ws = _code((CSRC / "flash_qmajor_ws.cuh").read_text())
    assert "flash_fwd_ws_kernel<D, MASK><<<" in ws
    for piece in ("tma_load(", "tma_store(", "mbar_wait(", "reg_dealloc<",
                  "reg_alloc<", "bar_sync(kFwTurn + wg", "bar_arrive(kFwTurn",
                  "drop_mix(", "fold16("):
        assert piece in ws, piece
    loop = ws[ws.index("reg_dealloc<kQmCopyRegs>();"):]
    assert "__syncthreads" not in loop and "cp_async16z" not in loop
    assert "flash_qmajor_ws.cuh" in _build._digest_files()
    before = _build._digest()
    path = csrc_copy / "flash_qmajor_ws.cuh"
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._digest() != before


def _paged_code() -> str:
    """The paged decode source with the kernel template it includes
    (``kv_decode.cuh``, shared with the dense cache's decode)."""
    code = _code((CSRC / "paged_attention.cu").read_text())
    assert '#include "kv_decode.cuh"' in code
    return code + _code((CSRC / "kv_decode.cuh").read_text())


def test_paged_source_takes_the_hopper_helpers_and_is_hashed_with_them(
        csrc_copy):
    """The paged decode kernel loads its pages with the TMA and mbarrier
    helpers of ``hopper.cuh``; an edit to the header rebuilds it."""
    code = _paged_code()
    assert '#include "hopper.cuh"' in code
    assert "paged_attention.cu" in _build.SOURCES
    assert {"paged_attention.cu", "kv_decode.cuh",
            "hopper.cuh"} <= set(_build._digest_files())
    before = _build._digest()
    path = csrc_copy / "hopper.cuh"
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build._digest() != before


def test_paged_source_runs_its_products_on_the_tensor_cores():
    code = _paged_code()
    assert "mma.sync.aligned.m16n8k16" in code
    assert "cp.async.bulk.tensor" in code and "cp.async.cg" not in code
