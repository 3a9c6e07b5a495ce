"""The port's tile table (``ops/autotune.py``, ``pick_blocks``) against the
JAX package's, on the CPU.

Keys, the groupsize rule and the table file are compared letter for letter
with JAX's; each candidate tile is held to its shared-memory budget and to
the tiles ``csrc/quant_matmul.cu`` instantiates. The kernels are not
run here (``tests/test_torch_kernels_gpu.py`` runs every tile on the card);
on the CPU the wrapper runs the plain version, which has no tiles.
"""

import itertools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sam_quantization_tpu.ops import autotune as jat
from sam_quantization_tpu.ops import quant_matmul as jqm
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import autotune as tat
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.tools import autotune as ttool

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def tables():
    """Both modules' cached tables reset before and after (JAX's module
    global ``_table``, as tests/test_packed.py resets it)."""
    jat._table = tat._table = None
    yield
    jat._table = tat._table = None


@pytest.mark.parametrize("dtype", DTYPES)
def test_candidates_and_table(tmp_path, tables, dtype):
    """tests/test_packed.py's autotune case: candidates divide N and K at
    ViT-H's qkv, more than one of them in bfloat16 (float32 instantiates
    only its default tile); a table round trip and lookup."""
    cands = tat.candidate_blocks(4096, 3840, 1280, 128, 128, dtype)
    assert all(3840 % bn == 0 and 1280 % bk == 0 for _, bn, bk in cands)
    assert len(cands) == len(tat.TILES[dtype]) and cands[0] == tat.default_tile(128, dtype)
    assert dtype == torch.float32 or len(cands) > 1
    path = str(tmp_path / "tab.json")
    key = tat._key(4096, 1280, 3840, 128, 4, dtype)
    json.dump({key: list(cands[-1])}, open(path, "w"))
    tat.load_table(path)
    assert tat.lookup(4096, 1280, 3840, 128, 4, dtype) == cands[-1]
    assert tat.lookup(4096, 1280, 1280, 128, 4, dtype) is None
    other = DTYPES[1 - DTYPES.index(dtype)]
    assert tat.lookup(4096, 1280, 3840, 128, 4, other) is None


def test_key_and_groupsize_rule_match_jax(tables):
    """``_key`` (bfloat16) is JAX's letter for letter, float32 adds ``f32``;
    an entry keyed as JAX's ``pick_blocks`` looks it up (groupsize 0 when
    the group spans K) is the one both packages find."""
    for M, K, N, g, bits in itertools.product((1, 4096, 4900), (128, 1280, 5120),
                                              (64, 1280, 3840), (0, 32, 128, 5120), (2, 3, 4, 8)):
        assert tat._key(M, K, N, g, bits) == jat._key(M, K, N, g, bits)
        assert tat._key(M, K, N, g, bits, torch.float32) == jat._key(M, K, N, g, bits) + "f32"
    for K, g in ((1280, 128), (1280, 1280), (128, 128), (256, 64)):
        gk = g if g < K else 0
        tile = tat.candidate_blocks(4096, 1280, K, g, 128)[-1]
        jat._table = {jat._key(4096, K, 1280, gk, 4): list(tile)}
        tat._table = {tat._key(4096, K, 1280, gk, 4): list(tile)}
        assert jqm.pick_blocks(4096, 1280, K, g, 128, 4) == tile
        assert tqm.pick_blocks(4096, 1280, K, g, 128, 4) == tile


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_table_file_round_trips_between_packages(tmp_path, tables, writer):
    """A table written by one package's format (``indent=1,
    sort_keys=True``) reads back through the other's ``load_table`` /
    ``lookup``."""
    path = tmp_path / "table.json"
    entries = {(4900, 1280, 3840, 128, 4): (128, 128, 128), (4096, 5120, 1280, 0, 2): (256, 64, 128)}
    table = {jat._key(*k): list(v) for k, v in entries.items()}
    if writer == "port":
        tat._table = {}
        with open(path, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        reader = jat
    else:
        jat._table = {}
        with open(path, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        reader = tat
    reader._table = None
    assert reader.load_table(str(path)) == table
    for k, v in entries.items():
        assert reader.lookup(*k) == v
    # JAX's caching: once read, the table stays, whatever path is given
    assert reader.load_table(str(tmp_path / "absent.json")) == table


@pytest.mark.parametrize("dtype", DTYPES)
def test_candidates_fit_hopper_and_are_the_built_tiles(dtype):
    """Every tile of TILES fits a block's shared memory (227 KB), and TILES
    is what csrc/quant_matmul.cu instantiates, the default first."""
    for bm, bn in tat.TILES[dtype]:
        assert tat.smem_bytes(bm, bn, dtype) <= tat.MAX_SMEM
    src = (Path(tqm.__file__).parents[1] / "csrc" / "quant_matmul.cu").read_text()
    macro = "SAMQ_TC" if dtype == torch.bfloat16 else "SAMQ_F32"
    built = [tuple(map(int, t)) for t in re.findall(rf"^\s*{macro}\((\d+), (\d+)\)$", src, re.M)]
    assert tuple(built) == tat.TILES[dtype]
    assert tat.smem_bytes(*tat.TILES[dtype][0], dtype) == {
        torch.bfloat16: 2 * 96 * 1024 + 16, torch.float32: (2 * 128 * 132 + 128 * 128) * 4}[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pb", [128, 48, 12])
def test_pick_blocks_takes_todays_tile_without_a_table(tables, tmp_path, dtype, pb):
    tat.load_table(str(tmp_path / "none.json"))
    want = {torch.bfloat16: (256, 128), torch.float32: (128, 128)}[dtype]
    assert tqm.pick_blocks(4900, 3840, 1280 * pb // 16, pb, pb, 4, dtype) == (
        *want, tqm.tile_rows(pb))
    assert tat.lookup(4900, 1280, 3840, 128, 4, dtype) is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_table_hit_outside_candidates_raises(tables, dtype):
    key = tat._key(4900, 1280, 3840, 128, 4, dtype)
    for bad in ([512, 128, 128], [128, 128, 64], [256, 256, 512]):
        tat._table = {key: bad}
        with pytest.raises(ValueError, match=key):
            tqm.pick_blocks(4900, 3840, 1280, 128, 128, 4, dtype)


@pytest.mark.parametrize("bits", [3, 4])
def test_cpu_output_ignores_the_table(tables, bits):
    """On the CPU the plain version runs, with a table entry or without."""
    r = np.random.default_rng(0)
    p = tpacked.quantize_rtn(torch.from_numpy(r.standard_normal((256, 128)).astype(np.float32)),
                             bits, 64)
    x = torch.from_numpy(r.standard_normal((70, 256)).astype(np.float32))
    tat._table = {}
    before = tqm.quant_matmul(x, p)
    tat._table = {tat._key(70, 256, 128, 64, bits, torch.float32): [64, 64, 128]}
    after = tqm.quant_matmul(x, p)
    assert torch.equal(before, after)
    assert torch.equal(tqm.quant_matmul_tiled(x, p, (64, 64, 128)), before)


def test_tuner_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        tat.tune_shape(64, 128, 128, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            tat.tune_shape(64, 128, 128)
        with pytest.raises(RuntimeError, match="CUDA card"):
            ttool.main(["--model", "vit_tiny", "--dtype", "f32", "--table", "unused.json"])



# ---------------------------------------------------------------------------
# The W-A8 kernels read the same table (JAX's _quant_matmul_a8_sym / _asym
# call pick_blocks): under JAX's bare key, among their own tiles.
# ---------------------------------------------------------------------------


def test_a8_candidates_fit_hopper_and_are_the_built_tiles():
    """TILES_A8 is what csrc/quant_matmul_a8.cu instantiates, the default
    first; every tile fits a block's shared memory at bits 2, 4, 8, sym and
    asym, with at least three stages (the producer's copies run two tiles
    ahead of its decode), four at the default tile (its stage count before
    it took a tile)."""
    src = (Path(tqm.__file__).parents[1] / "csrc" / "quant_matmul_a8.cu").read_text()
    built = [tuple(map(int, t)) for t in re.findall(r"^\s*SAMQ_A8\((\d+), (\d+)\)$", src, re.M)]
    assert tuple(built) == tat.TILES_A8 and tat.TILES_A8[0] == (128, 128)
    for (bm, bn), bits, sym in itertools.product(tat.TILES_A8, (2, 4, 8), (True, False)):
        stages, smem = tat.smem_bytes_a8(bm, bn, bits, sym)
        assert 3 <= stages <= 4 and smem <= tat.MAX_SMEM, (bm, bn, bits, sym, stages, smem)
        assert (bm, bn) != (128, 128) or stages == 4
    # the 8-bit asymmetric 256 x 128 stage: about 70 KB, so three stages fit, not four
    assert tat.smem_bytes_a8(256, 128, 8, False) == (3, 3 * (71680 + 16) + 1024)


@pytest.mark.parametrize("M,N", [(4900, 3840), (4096, 1280), (100, 250), (4096, 200)])
def test_a8_candidates_follow_the_weight_only_rules(M, N):
    """The default first, then each other tile whose bn divides N and whose
    bm is at most max(M, 128); bk is tile_rows(pack_block)."""
    cands = tat.candidate_blocks_a8(M, N, 1280, 128, 128)
    want = [(128, 128)] + [t for t in tat.TILES_A8[1:] if N % t[1] == 0 and t[0] <= max(M, 128)]
    assert cands == [(*t, 128) for t in want]
    assert tat.candidate_blocks_a8(M, N, 384, 48, 48)[0] == (128, 128, tqm.tile_rows(48))


@pytest.mark.parametrize("entry", [None, (256, 64, 128), (256, 128, 128), (128, 128, 128)])
def test_a8_lookup_reads_jax_bare_key(tables, entry):
    """pick_blocks_a8 finds the entry JAX's pick_blocks finds for its W-A8
    wrappers (the bare key, ``groupsize if groupsize < K else 0``), whatever
    the output dtype; a float32-suffixed entry is not read; no entry, the
    default 128 x 128."""
    for K, g in ((1280, 128), (1280, 1280)):
        gk = g if g < K else 0
        table = {} if entry is None else {jat._key(4900, K, 3840, gk, 4): list(entry)}
        jat._table, tat._table = dict(table), dict(table)
        got = tqm.pick_blocks_a8(4900, 3840, K, g, 128, 4)
        assert got == (entry or (128, 128, 128))
        if entry is not None:
            assert jqm.pick_blocks(4900, 3840, K, g, 128, 4) == got
        tat._table = {tat._key(4900, K, 3840, gk, 4, torch.float32): [256, 64, 128]}
        assert tqm.pick_blocks_a8(4900, 3840, K, g, 128, 4) == (128, 128, 128)


def test_a8_lookup_raises_on_a_non_candidate(tables):
    """An entry that names no W-A8 candidate raises ValueError naming its
    key, as pick_blocks does: a tile no kernel has, a K tile other than
    tile_rows, a 64-wide tile where 64 does not divide N, a 256-row tile
    for M at most 128."""
    for M, N, bad in ((4900, 3840, [192, 128, 128]), (4900, 3840, [128, 128, 64]),
                      (4900, 200, [256, 64, 128]), (100, 3840, [256, 128, 128])):
        key = tat._key(M, 1280, N, 128, 4)
        tat._table = {key: bad}
        with pytest.raises(ValueError, match=key):
            tqm.pick_blocks_a8(M, N, 1280, 128, 128, 4)


@pytest.mark.parametrize("K,g,pb,bits,main", [
    (1280, 128, 128, 4, True), (1280, 1280, 128, 8, True), (384, 32, 32, 4, True),
    (384, 64, 64, 2, True), (384, 48, 48, 4, False), (384, 16, 16, 4, False),
    (256, 96, 32, 4, False), (128, 32, 32, 2, False), (384, 128, 16, 8, True)])
def test_a8_main_build_predicate(K, g, pb, bits, main):
    """Which layouts take the main build (the tiles) and which FINE (its one
    tile, the table ignored), as run_a8_bits decides: groups of 32 or 64,
    whole 128-row K tiles or all of K; 128-row K tiles; four word rows a
    plane."""
    assert tqm.a8_main_build(K, g, pb, bits) == main


@pytest.mark.parametrize("sym", [True, False])
def test_a8_cpu_output_ignores_the_table(tables, sym):
    """On the CPU the W-A8 plain version runs, with a table entry or without,
    and a8_matmul_tiled is that plain version at any tile."""
    r = np.random.default_rng(1)
    w = torch.from_numpy(r.standard_normal((256, 128)).astype(np.float32) * 0.05)
    p = tpacked.with_act_bits(tpacked.quantize_rtn(w, 4, 64, sym), 8)
    xq, xs = tqm.quantize_activations_int8(
        torch.from_numpy(r.standard_normal((300, 256)).astype(np.float32)))
    tat._table = {}
    before = tqm.a8_matmul(xq, xs, p, torch.float32, sym)
    tat._table = {tat._key(300, 256, 128, 64, 4): [256, 64, 128]}
    assert torch.equal(tqm.a8_matmul(xq, xs, p, torch.float32, sym), before)
    assert torch.equal(tqm.a8_matmul_tiled(xq, xs, p, (256, 64, 128), torch.float32, sym), before)
    assert torch.equal(before, tqm.a8_matmul_plain(xq, xs, p, torch.float32, sym))
