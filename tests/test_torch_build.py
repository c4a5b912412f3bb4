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
    hashes; so do the split dk/dv instances (its dk/dv mode)."""
    md = _code((CSRC / "flash_attention_bwd_md.cu").read_text())
    assert '#include "flash_kmajor_ws.cuh"' in md
    assert "launch_one_pass_ws<D, MASK, DROP>" in md
    assert "launch_dkv_ws<D, MASK, DROP>" in md
    assert "launch_bwd<" not in md
    assert "launch_one_pass<" not in md
    ws = _code((CSRC / "flash_kmajor_ws.cuh").read_text())
    for piece in ("tma_load(", "mbar_wait(", "reg_dealloc<", "reg_alloc<",
                  "cp.async.mbarrier.arrive", "tensor_add_f32("):
        assert piece in ws, piece
    for loop in _ws_loops(ws):
        assert "__syncthreads" not in loop and "cp_async16z" not in loop
    assert "flash_kmajor_ws.cuh" in _build._digest_files()
    before = _build._digest()
    path = csrc_copy / "flash_kmajor_ws.cuh"
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._digest() != before


def _ws_loops(ws: str) -> list:
    """The key-major warp-specialized kernel's product threads' code, a
    piece per branch of the kernel (the wide modes', the bf16
    instances'): from the branch's ``reg_alloc`` to its end."""
    kernel = ws[ws.index("flash_bwd_ws_kernel(const"):]
    kernel = kernel[:kernel.index("\n}\n")]
    branches = kernel.split("\n  } else {\n")
    assert len(branches) == 2
    return [b[b.index("reg_alloc<kWsRegs>();"):] for b in branches]


def _function(code: str, name: str) -> str:
    """The body of the C++ function ``name`` in ``code`` (from its name to
    its closing brace at column 0)."""
    i = code.index(f" {name}(")
    return code[i:(code + "\n").index("\n}\n", i)]


def test_md_forward_takes_the_persistent_warp_specialized_kernel(csrc_copy):
    """The forward's dropout entries (#3d, #3md) launch the warp-specialized
    persistent kernel of ``flash_qmajor_ws.cuh`` (a copying thread on TMA,
    an mbarrier ring, the product warpgroups taking turns, O out by TMA
    stores, no block-wide barrier past the prologue), which the library's
    name hashes; the forward's without dropout (#3, #3m) keep the
    query-major template.  The split dq kernel's mask and dropout
    instances (#5md) are the persistent kernel's dq mode
    (:func:`test_md_dq_takes_the_persistent_kernel`)."""
    md = _code((CSRC / "flash_attention_md.cu").read_text())
    assert '#include "flash_qmajor_ws.cuh"' in md
    fwd = _function(md, "fwd_drop")
    assert "launch_qm_ws<D, MASK, false, true>" in fwd
    assert "launch_qmajor<" not in fwd
    plain = _code((CSRC / "flash_attention.cu").read_text())
    assert re.search(r"launch_qmajor<D, false, ", plain)
    assert "launch_qm_ws" not in plain
    ws = _code((CSRC / "flash_qmajor_ws.cuh").read_text())
    assert "flash_fwd_ws_kernel<D, MASK, DQ, DROP, kOpBf16, 2, F32>\n" \
        "      <<<" in ws
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


@pytest.mark.parametrize("src,op", [
    ("paged_wide_tc_bf16.cu", "kDecWideBf16"),
    ("paged_wide_tc_f16.cu", "kDecWideF16"),
    ("paged_wide_tc_f32.cu", "kDecWideF32")])
def test_wide_paged_takes_the_decode_template(src, op):
    """#7w's TMA modes are wide operand modes of #7's kernel template:
    each instance source (no entries of its own, launched through
    ``apex_paged_wide``) launches ``paged_decode_kernel`` in its mode
    through ``launch_paged_wide_d``; the template's wide branch loads its
    stages on TMA into an mbarrier ring with no block barrier in the loop
    (16-bit products on ``mma.sync``), and #7's bf16 instance is its
    other branch, its launch as it was."""
    assert _build.SOURCES[src] == {}
    code = _code((CSRC / src).read_text())
    assert '#include "kv_decode.cuh"' in code
    assert f"launch_paged_wide_d<{op}>(" in code
    entry = _function(_code((CSRC / "paged_wide.cu").read_text()),
                      "apex_paged_wide")
    assert f"{src[:-3]}(t, s)" in entry
    dec = _code((CSRC / "kv_decode.cuh").read_text())
    launch = _function(dec, "launch_paged_wide")
    assert "paged_decode_kernel<R, D, SR, false, OP>" in launch
    kernel = dec[dec.index("paged_decode_kernel(const"):]
    kernel = kernel[:kernel.index("\n}\n")]
    branch = kernel[:kernel.index("\n  } else {\n")]
    assert "if constexpr (OP != kDecBf16)" in branch
    assert "paged_wide_body<OP, G, D, PS>(" in branch
    body = dec[dec.index("void paged_wide_body("):]
    body = body[:body.index("\n}\n")]
    for piece in ("tma_load4(", "mbar_wait(", "mbar_expect_tx(",
                  "mbar_arrive(", "ldsm_x4(", "mma16<F16>(", "movmatrix_t("):
        assert piece in body, piece
    loops = body[body.index("for (int i = grp; i < n;"):
                 body.index("bar_sync(1, kWarps * 32)")]
    assert "__syncthreads" not in loops and "cp_async" not in loops
    paged = _code((CSRC / "paged_attention.cu").read_text())
    assert "paged_decode_kernel<G, D, PS><<<" in paged


def test_md_dkv_takes_the_warp_specialized_key_major_kernel():
    """``apex_flash_attention_bwd_dkv_md`` (#6md) reaches the
    warp-specialized key-major kernel in its dk/dv mode: the pre-pass's
    bits by a bulk copy (no mask byte is read), the folded keep hash,
    ``setmaxnreg``, no block barrier in the loop, and an ordered grid,
    the longest key blocks first."""
    md = _code((CSRC / "flash_attention_bwd_md.cu").read_text())
    entry = _function(md, "apex_flash_attention_bwd_dkv_md")
    assert "entry<false>(" in entry
    bwd = _function(md, "bwd_md")
    assert "launch_dkv_ws<D, MASK, DROP>(" in bwd
    ws = _code((CSRC / "flash_kmajor_ws.cuh").read_text())
    launch = _function(ws, "launch_dkv_ws")
    # (the fp32-output instances share the launch: F32 is false here)
    assert "flash_bwd_ws_kernel<D, false, MASK, DROP, kOpBf16, F32>" \
        in launch
    assert "group" in launch and "kL2Half" in launch
    kernel = ws[ws.index("flash_bwd_ws_kernel(const"):]
    kernel = kernel[:kernel.index("\n}\n")]
    for piece in ("bulk_load(", "fold16(", "drop_keep_folded(",
                  "reg_dealloc<", "reg_alloc<", "kb = r / gsize"):
        assert piece in kernel, piece
    assert not re.search(r"md\.mask\b", ws) and "mask_ld" not in ws
    for loop in _ws_loops(ws):
        assert "__syncthreads" not in loop and "cp_async16z" not in loop


def test_wide_dkv_takes_the_warp_specialized_key_major_kernel():
    """``apex_flash_wide_dkv`` (#6w) on 16-bit operands and on fp32 as
    planes reaches the key-major warp-specialized kernel's wide modes:
    each dk/dv instance source (no entries of its own) launches
    ``flash_bwd_ws_kernel`` through ``launch_wide_dkv_ws``, whose blocks
    go the longest key blocks first; the wide branch copies on TMA (or
    by threads for rows TMA cannot read), hashes the keep bits, splits
    fp32 into planes and writes dk and dv once (no atomics).  The
    CUDA-core ``wide_dkv_kernel`` is kept for fp32 at the bucket 256
    alone."""
    wide = _code((CSRC / "flash_wide.cu").read_text())
    tc = _function(wide, "tensor_cores")
    for fn in ("wide_tc_dkv_f32(", "wide_tc_dkv_bf16(", "wide_tc_dkv_f16(",
               "wide_tc_dkv_rows("):
        assert fn in tc, fn
    assert "kDkv" not in _function(wide, "run")
    assert "template <typename T, int D>\n__global__" not in wide
    assert "round_to" not in wide
    for src in ("flash_wide_tc_dkv_f16.cu", "flash_wide_tc_dkv_bf16.cu",
                "flash_wide_tc_dkv_f32.cu", "flash_wide_tc_dkv_rows.cu"):
        assert _build.SOURCES[src] == {}
        code = _code((CSRC / src).read_text())
        assert '#include "flash_wide_ws.cuh"' in code
        assert "launch_wide_dkv_d<" in code
    ws = _code((CSRC / "flash_wide_ws.cuh").read_text())
    launch = _function(ws, "launch_wide_dkv_ws")
    assert "flash_bwd_ws_kernel<D, false, false, DROP, OP>" in launch
    assert "group" in launch and "kL2Half" in launch
    kernel = _code((CSRC / "flash_kmajor_ws.cuh").read_text())
    kernel = kernel[kernel.index("flash_bwd_ws_kernel(const"):]
    kernel = kernel[:kernel.index("\n}\n")]
    branch = kernel[:kernel.index("\n  } else {\n")]
    assert "if constexpr (OP != kOpBf16)" in branch
    for piece in ("tma_load(", "mbar_wait(", "copy_tile<", "reg_dealloc<",
                  "reg_alloc<", "fold16(", "drop_keep_folded(",
                  "wgmma_rs<F16>(", "split3(", "hr / gsize"):
        assert piece in branch, piece
    assert "atomic" not in branch


def test_md_dq_takes_the_persistent_kernel():
    """``apex_flash_attention_bwd_dq_md`` (#5md) reaches the persistent
    query-major kernel's dq mode: the scheduling and loading warps, the
    turns, the hash under the S product, dq out by TMA stores."""
    md = _code((CSRC / "flash_attention_md.cu").read_text())
    entry = _function(md, "apex_flash_attention_bwd_dq_md")
    assert "dq_entry<" in entry
    assert "launch_qm_ws<D, MASK, true, DROP>(" in _function(md, "dq_md")
    ws = _code((CSRC / "flash_qmajor_ws.cuh").read_text())
    dq = ws[ws.index("auto o_desc = [&](int ks)"):]
    dq = dq[:dq.index("\n    return;\n  }\n")]
    for piece in ("bar_sync(kFwTurn + wg", "bar_arrive(kFwTurn + 1 - wg",
                  "drop_mix(", "fold16(", "rs_product(acc, pa, ",
                  "wgmma_wait<2>();", "tma_store("):
        assert piece in dq, piece
    # dQ += dS K: dS's register fragments as A (rs_product, shared with
    # the forward's P V)
    rs = ws[ws.index("auto rs_product = "):ws.index("auto pack_a = ")]
    assert "wgmma_rs<F16>(acc, a[" in rs
    # the hash sits between the products' issue and the wait on S
    turn = dq.index("bar_arrive(kFwTurn + 1 - wg")
    assert turn < dq.index("keep_bits();") < dq.index("wgmma_wait<2>();")


@pytest.mark.parametrize("name,kernel", [
    ("flash_kmajor.cuh", "flash_bwd_kernel"),
    ("flash_qmajor.cuh", "flash_qmajor_kernel")])
def test_the_older_templates_have_no_drop_instances(name, kernel):
    """The key-major template serves #4 and #6 alone and the query-major
    one #3, #3m and #5: no DROP parameter, no keep hash, and the
    query-major dq kernel no mask."""
    code = _code((CSRC / name).read_text())
    assert "DROP" not in code and "drop_keep" not in code
    assert "seed3" not in code
    head = code[code.index(f"{kernel}(") - 200:code.index(f"{kernel}(")]
    assert "DROP" not in head
    if name == "flash_kmajor.cuh":
        assert "MASK" not in code and "MdParams" not in code
    else:
        assert "static_assert(!(DQ && MASK)" in code


@pytest.mark.parametrize("entry", ["apex_flash_attention_bwd_dq_md",
                                   "apex_flash_attention_bwd_dkv_md"])
def test_split_md_entries_run_no_pre_pass(entry):
    """Handed the pre-pass's filled scratch, neither split entry runs the
    pre-pass (``apex_flash_mask_tiles`` does, once for both): their C
    entries and everything they call take no mask and launch no
    ``mask_tiles_kernel``; the split backward's wrapper runs it once."""
    src = "flash_attention_md.cu" if "dq" in entry \
        else "flash_attention_bwd_md.cu"
    code = _code((CSRC / src).read_text())
    body = _function(code, entry)
    assert "mask_ld" not in body.split("{", 1)[0]
    assert "launch_mask_tiles" not in body and "pre_pass" not in body
    if "dq" in entry:
        for fn in ("dq_entry", "dq_md"):
            assert "launch_mask_tiles" not in _function(code, fn)
            assert "pre_pass" not in _function(code, fn)
    else:
        bwd = _function(code, "bwd_md")
        # the pre-pass only in the one-pass branch
        dkv = bwd[bwd.index("} else {"):]
        assert "launch_mask_tiles" not in dkv
    pre = _function(_code((CSRC / "flash_attention_md.cu").read_text()),
                    "apex_flash_mask_tiles")
    assert "launch_mask_tiles(" in pre
    assert "apex_flash_mask_tiles" in _build.UNCOUNTED[
        "flash_attention_md.cu"]
