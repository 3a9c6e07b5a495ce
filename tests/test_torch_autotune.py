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

