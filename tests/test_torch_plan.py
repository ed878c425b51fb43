"""Plan parity: the port's specialization flow against the JAX package's.

The flow is pure Python in both packages, so under the same target the
port must produce the very same frozen plan (equal content hashes) for
every runnable cell.  The H100 target then plans the chip-smoke shape
for one card.
"""

import dataclasses
import re

import pytest

import repro.configs as rcfg
import repro.core as rcore
import repro_torch.configs as tcfg
import repro_torch.core as tcore
from repro_torch.core import costmodel as tcm
from repro_torch.core.describe import describe_program
from repro_torch.hw import get_target
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import tiled_matmul as tmm
from repro_torch.models import lm as tlm

SMEM_PER_BLOCK = 232_448          # H100: 227 KB of shared memory per block
RUNNABLE = [(a, s) for a, s, ok, _ in rcfg.all_cells() if ok]


def test_cells_and_param_counts_match():
    assert tcfg.all_cells() == rcfg.all_cells()
    for name in rcfg.all_archs():
        r, t = rcfg.get_arch(name), tcfg.get_arch(name)
        assert t.param_count() == r.param_count(), name
        assert t.active_param_count() == r.active_param_count(), name
        assert dataclasses.asdict(t) == dataclasses.asdict(r), name
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(r.reduced()), name


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}@{s}" for a, s in RUNNABLE])
def test_plan_hash_matches_reference_tpu_v5e(arch, shape):
    ref = rcore.specialize(arch, shape, target="tpu-v5e", cache=False)
    port = tcore.specialize(arch, shape, target="tpu-v5e", cache=False)
    assert port.content_hash() == ref.content_hash()


def test_reduced_serve_plan_matches_reference():
    shape = rcfg.ShapeConfig("serve_demo", "decode", 128, 4)
    ref = rcore.specialize(rcfg.get_arch("qwen3-8b").reduced(), shape,
                           mesh_shape=(1, 1))
    port = tcore.specialize(tcfg.get_arch("qwen3-8b").reduced(),
                            tcfg.ShapeConfig("serve_demo", "decode", 128, 4),
                            mesh_shape=(1, 1), target="tpu-v5e")
    assert port.content_hash() == ref.content_hash()


def test_h100_target_is_the_default_and_holds_data_sheet_values():
    import inspect
    sig = inspect.signature(tcore.specialize)
    assert sig.parameters["target"].default == "h100-sxm"
    t = get_target("h100-sxm")
    assert (t.hbm_bytes, t.hbm_bw, t.peak_bf16_flops, t.vmem_bytes,
            t.ici_link_bw) == (80 * 10**9, 3.35e12, 989e12, SMEM_PER_BLOCK,
                               450e9)


def test_h100_plan_for_the_chip_smoke_shape():
    plan = tcore.specialize(tcfg.get_arch("qwen3-8b"),
                            tcfg.ShapeConfig("serve_h100", "decode", 2048, 8),
                            mesh_shape=(1, 1), target="h100-sxm")
    est = plan.estimates
    assert plan.target == "h100-sxm"
    assert est["kv_residency"] == "paged"
    assert est["kv_admission"] == "reserve"
    assert est["kv_prefill_mode"] == "inline"
    assert est["kv_block_len"] == 256 and est["kv_n_blocks"] == 64
    # the tiles the serving path runs fit one block's shared memory
    dec = plan.partitions["decode_attention"]
    assert dec.vmem_bytes <= SMEM_PER_BLOCK
    assert dec.blocks["block_kv"] in tdec.KERNEL_TILES
    G = 32 // 8
    assert tdec.smem_bytes(G, dec.blocks["block_kv"]) <= SMEM_PER_BLOCK
    # a decode-shape plan carries no flash tile: the documented default
    assert "flash_attention" not in plan.partitions
    rows, bkv = tfa.kernel_tiles(G)
    assert tfa.smem_bytes(rows, bkv) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}@{s}" for a, s in RUNNABLE])
def test_h100_matmul_tile_is_a_kernel_tile_that_fits(arch, shape):
    """On the card the tile is one the CUDA kernel is built for, its
    operand stages fit the pass's share of shared memory, the fp32
    accumulator is counted in registers, and the log records that tile."""
    plan = tcore.specialize(arch, shape, target="h100-sxm", cache=False)
    bp = plan.partitions["tiled_matmul"]
    tiles = (bp.blocks["bm"], bp.blocks["bk"], bp.blocks["bn"])
    budget = 0.75 * SMEM_PER_BLOCK
    assert tiles in tmm.KERNEL_TILES
    bm, bk, bn = tiles
    assert bp.n_buffers * (bm * bk + bk * bn) * 2 <= budget
    assert bp.vmem_bytes == tmm.smem_bytes(*tiles) <= budget
    assert "accumulator in registers" in bp.grid_note
    logged = [(d, why) for _, subj, d, why in plan.log
              if subj == "tiled_matmul"]
    assert [d for d, _ in logged] == [f"{bm}x{bk}x{bn}"]
    assert "accumulator in registers" in logged[0][1]


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}@{s}" for a, s in RUNNABLE])
def test_h100_flash_tile_is_a_kernel_tile_that_fits(arch, shape):
    """On the card the flash tile is one the CUDA kernel is built for:
    ``block_q = rows // G`` whole positions of a tile's rows (G = 7: 18
    positions in 128 rows) and ``block_kv`` in its tile set, Q plus the
    K/V ring within the pass's share of shared memory, and the log says
    so.  An arch the kernel is not built for gets no tile and a logged
    reason; a cell without a prefill attention op gets neither."""
    plan = tcore.specialize(arch, shape, target="h100-sxm", cache=False)
    a = tcfg.get_arch(arch)
    bp = plan.partitions.get("flash_attention")
    logged = [(d, why) for _, subj, d, why in plan.log
              if subj == "flash_attention"]
    # the group a rank's flash call runs at (a piece of a group where
    # the 16-wide model axis splits the heads but not the kv heads)
    G = tlm.kernel_instances(a, "prefill", plan)[0].group \
        if a.has_attention else 1
    if bp is None:
        if logged:
            assert [d for d, _ in logged] == ["no kernel tile"]
            assert a.hd not in tfa.HEAD_DIMS or G not in tfa.GROUPS
        return
    bq, bkv = bp.blocks["block_q"], bp.blocks["block_kv"]
    rows, _ = tfa.kernel_tiles(G, bq, bkv)
    assert bq == rows // G and bq * G > rows - G
    assert bp.blocks["head_dim"] == a.hd and a.hd in tfa.HEAD_DIMS
    assert bp.n_buffers == tfa.STAGES
    budget = 0.75 * SMEM_PER_BLOCK
    assert rows * a.hd * 2 + bp.n_buffers * 2 * bkv * a.hd * 2 <= budget
    assert bp.vmem_bytes == tfa.smem_bytes(rows, bkv, a.hd) <= budget
    assert "TMA ring" in bp.grid_note
    assert "accumulator in registers" in bp.grid_note
    assert [d for d, _ in logged] == [f"block_q={bq} block_kv={bkv}"]
    assert "accumulator in registers" in logged[0][1]
    # the largest tile that fits: two 64-row warpgroups
    assert rows == max(r for r, _ in tfa.KERNEL_TILES)


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}@{s}" for a, s in RUNNABLE])
def test_h100_decode_tile_is_a_split_kv_kernel_tile(arch, shape):
    """On the card ``block_kv`` is a tile the split-KV kernel is built
    for, its shared memory is the kernel's (``smem_bytes``), and the
    widest tile whose splits fill the card at the plan's batch is taken;
    an arch the kernel is not built for gets a logged reason instead."""
    plan = tcore.specialize(arch, shape, target="h100-sxm", cache=False)
    a = tcfg.get_arch(arch)
    bp = plan.partitions.get("decode_attention")
    logged = [(d, why) for _, subj, d, why in plan.log
              if subj == "decode_attention"]
    K = int(plan.estimates.get("kv_heads_padded", a.n_kv_heads or 1))
    G = int(plan.estimates.get("heads_padded", a.n_heads)) // K
    if bp is None:
        if logged:
            assert [d for d, _ in logged] == ["no kernel tile"]
            assert not tdec.takes_group(G, a.hd)
        return
    tile = bp.blocks["block_kv"]
    assert tdec.kernel_tile("x", tile) == tile
    assert bp.n_buffers == tdec.STAGES
    assert bp.vmem_bytes == tdec.smem_bytes(G, tile, a.hd) \
        <= 0.75 * SMEM_PER_BLOCK
    sc = tcfg.SHAPES[shape]
    B, cap = sc.global_batch, sc.seq_len
    ctas = {t: B * K * tdec.decode_split(B, K, cap, t)[0]
            for t in tdec.KERNEL_TILES}
    full = [t for t in tdec.KERNEL_TILES if ctas[t] >= tdec.SPLIT_CTAS]
    assert tile == (max(full) if full else min(tdec.KERNEL_TILES))
    assert [d for d, _ in logged] == [f"block_kv={tile}"]
    assert "cp.async" in logged[0][1] and "cp.async" in bp.grid_note


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}@{s}" for a, s in RUNNABLE])
def test_h100_ssd_tile_is_a_chunk_parallel_kernel_tile(arch, shape):
    """On the card the SSD chunk is one the three-pass kernel is built
    for, heads_block is 1 (validated, unused by the CUDA grid), and the
    shared memory charged is the chunk-scan pass's."""
    plan = tcore.specialize(arch, shape, target="h100-sxm", cache=False)
    bp = plan.partitions.get("ssd_scan")
    logged = [(d, why) for _, subj, d, why in plan.log if subj == "ssd_scan"]
    if bp is None:
        a = tcfg.get_arch(arch)
        if logged:
            assert [d for d, _ in logged] == ["no kernel tile"]
            assert (a.ssm_head_dim, a.ssm_state) not in tssd.KERNEL_WIDTHS
        return
    P, N = bp.blocks["head_dim"], bp.blocks["state"]
    chunk = bp.blocks["chunk"]
    assert tssd.kernel_tiles(chunk, bp.blocks["heads_block"], 64) == \
        (chunk, 1)
    assert bp.vmem_bytes == tssd.smem_bytes(P, N) <= 0.75 * SMEM_PER_BLOCK
    assert [d for d, _ in logged] == [f"chunk={chunk} heads_block=1"]
    assert "unused by the CUDA grid" in logged[0][1]


def test_h100_prefill_plan_flash_tile_runs_through_kernel_tiles():
    """qwen3-8b's prefill-shape plan on the card's 16x16 mesh: a rank
    holds 2 of a kv head's 4 query heads (8 kv heads do not split 16
    ways), so its flash call runs at G = 2: 64 positions x G=2 = 128
    rows by 128 kv rows, which the kernel takes; a RunCfg carries the
    plan's tile with or without the mesh, never another, so a run of
    the mesh plan at the whole group of 4 (256 rows) is refused, and a
    one-card run takes the one-card plan's tile; the tpu-v5e plan keeps
    its TPU tile (512 x 512 per head), which the CUDA kernel refuses."""
    from repro_torch.core.passes.lowering import build_run_cfg
    arch = tcfg.get_arch("qwen3-8b")
    plan = tcore.specialize(arch, "prefill_32k", target="h100-sxm",
                            cache=False)
    bp = plan.partitions["flash_attention"]
    assert (bp.blocks["block_q"], bp.blocks["block_kv"]) == (64, 128)
    assert tlm.kernel_instances(arch, "prefill", plan)[0].group == 2
    assert tfa.kernel_tiles(2, 64, 128) == (128, 128)
    assert build_run_cfg(plan, arch).flash_tiles == (64, 128)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(4, 64, 128)
    one = tcore.specialize(arch, "prefill_32k", mesh_shape=(1, 1),
                           target="h100-sxm", cache=False)
    assert build_run_cfg(one, arch).flash_tiles == (32, 128)
    assert tfa.kernel_tiles(4, 32, 128) == (128, 128)
    tpu = tcore.specialize(arch, "prefill_32k", target="tpu-v5e",
                           cache=False).partitions["flash_attention"]
    assert (tpu.blocks["block_q"], tpu.blocks["block_kv"]) == (512, 512)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(2, tpu.blocks["block_q"], tpu.blocks["block_kv"])


def test_tpu_v5e_plans_a_one_sequence_grant_pool_for_full_qwen3():
    """Why the port needs a card target: on v5e the 16 GiB of
    weights leave room for one sequence, and the pool is a grant pool."""
    plan = tcore.specialize(tcfg.get_arch("qwen3-8b"),
                            tcfg.ShapeConfig("serve_h100", "decode", 2048, 8),
                            mesh_shape=(1, 1), target="tpu-v5e")
    assert plan.estimates["kv_admission"] == "grant"
    assert plan.estimates["kv_n_blocks"] == 8


def _h100(name, kind):
    return tcore.specialize(tcfg.get_arch(name),
                            tcfg.ShapeConfig("s", kind, 2048, 8),
                            mesh_shape=(1, 1), target="h100-sxm", cache=False)


def test_h100_plans_record_hymba_tiles_at_group_5_head_dim_64():
    """hymba-1.5b on ``h100-sxm`` (25 / 5 heads of 64, kept unpadded on
    one card): the decode plan records the split-KV decode tile at
    head_dim 64 beside its SSD chunk, the prefill plan the flash tile of
    25 positions (125 of 128 rows), both tiles the kernels take, with
    their shared memory at head_dim 64; the decode plan is paged with
    reserve admission, 64 blocks of 256 rows, 512 host blocks and prefix
    reuse on."""
    arch = tcfg.get_arch("hymba-1.5b")
    dplan = _h100("hymba-1.5b", "decode")
    est = dplan.estimates
    assert est["heads_padded"] == 25 and est["kv_heads_padded"] == 5
    assert (est["kv_residency"], est["kv_admission"], est["kv_n_blocks"],
            est["kv_block_len"], est["kv_host_blocks"],
            est["kv_prefix_reuse"]) == ("paged", "reserve", 64, 256, 512,
                                        "on")
    dec = dplan.partitions["decode_attention"]
    assert dict(dec.blocks) == {"block_kv": 256, "head_dim": 64}
    assert dec.vmem_bytes == tdec.smem_bytes(5, 256, 64)
    assert tdec.takes_group(5, arch.hd)
    assert dict(dplan.partitions["ssd_scan"].blocks) == {
        "chunk": 256, "heads_block": 1, "head_dim": 64, "state": 16}
    pplan = _h100("hymba-1.5b", "prefill")
    fl = pplan.partitions["flash_attention"]
    assert dict(fl.blocks) == {"block_q": 25, "block_kv": 128,
                               "head_dim": 64}
    assert fl.vmem_bytes == tfa.smem_bytes(128, 128, 64)
    assert tfa.kernel_tiles(5, 25, 128) == (128, 128)
    assert "128 query rows hold 25 positions x G=5" in fl.grid_note


# the parent's H100 plans of the archs served before hymba: content hash
# prefixes, which the head_dim 64 / G = 5 branches leave as they were
H100_HASHES = {
    ("qwen3-8b", "decode"): "2ca1ad027c737728",
    ("qwen3-8b", "prefill"): "231de874015dc3de",
    ("mamba2-2.7b", "decode"): "47f25c4ac4e84938",
    ("mamba2-2.7b", "prefill"): "cdc59b59788748a6",
    ("deepseek-coder-33b", "decode"): "155dc37ab09a0ed3",
    ("deepseek-coder-33b", "prefill"): "579a03790b8693f3",
    ("minitron-8b", "decode"): "51584680a69d1a5a",
    ("minitron-8b", "prefill"): "473a3a54330bece0",
}


@pytest.mark.parametrize("name,kind", sorted(H100_HASHES))
def test_h100_plans_of_the_other_archs_are_unchanged(name, kind):
    assert _h100(name, kind).content_hash()[:16] == H100_HASHES[name, kind]


def test_h100_minitron_plans_record_the_g4_tiles():
    """minitron-8b takes every kernel as built (32 / 8 heads of 128):
    decode tile 256, flash 32 positions x 128 kv rows."""
    dplan = _h100("minitron-8b", "decode")
    assert dict(dplan.partitions["decode_attention"].blocks) == {
        "block_kv": 256, "head_dim": 128}
    assert dplan.estimates["kv_residency"] == "paged"
    fl = _h100("minitron-8b", "prefill").partitions["flash_attention"]
    assert dict(fl.blocks) == {"block_q": 32, "block_kv": 128,
                               "head_dim": 128}


# ---------------------------------------------------------------------
# the CUDA train plan's step-peak estimate (ROADMAP §3, F2)
# ---------------------------------------------------------------------

TRAIN_2K = tcfg.ShapeConfig("train_2k", "train", 2048, 1)
LADDER = ("none", "full")
GIB = 2 ** 30


def _train_plan(n_layers=0, arch=None, shape=TRAIN_2K):
    arch = arch or tcfg.get_arch("qwen3-8b")
    if n_layers:
        arch = dataclasses.replace(arch, n_layers=n_layers)
    return tcore.specialize(arch, shape, mesh_shape=(1, 1),
                            target="h100-sxm", cache=False)


def _rungs_tried(plan):
    """The remat decision's log entry and the step-peak estimate (GiB) of
    each rung the pass tried, in order."""
    log = [e for e in plan.log if e[:2] == ("communication", "remat")]
    assert len(log) == 1
    tried = re.search(r"eager step peak (.*?) GiB against", log[0][3])
    return log[0], [(p, float(g)) for p, g in
                    (r.split(" ") for r in tried.group(1).split(", "))]


def test_h100_train_plan_picks_the_least_remat_its_step_peak_admits():
    """Full-width, full-depth qwen3-8b at 2048 x 1: the plan records the
    eager step's peak (state, the bf16 gradient buffer, saved
    activations, transients) under its own keys, and its remat is the
    first of none -> full whose estimate is under 0.95 of the card:
    ``full``, since none's estimate exceeds the budget."""
    plan = _train_plan()
    est = plan.estimates
    budget = est["step_budget_bytes"]
    assert budget == 0.95 * get_target("h100-sxm").hbm_bytes
    assert est["step_fits"] == 1.0 and est["step_peak_bytes"] <= budget
    params = sum(t.nbytes for t in describe_program(
        tcfg.get_arch("qwen3-8b"), TRAIN_2K).by_role(tcore.Role.PARAM))
    assert est["step_grad_bytes"] == params          # bf16, one microbatch
    assert est["step_peak_bytes"] > (est["persistent_bytes_per_dev"]
                                     + est["step_grad_bytes"])
    chosen = plan.comm.remat_policy
    assert chosen == "full"
    entry, tried = _rungs_tried(plan)
    assert entry[2] == chosen
    assert [p for p, _ in tried] == list(LADDER[:LADDER.index(chosen) + 1])
    assert all(gib > budget / GIB for _, gib in tried[:-1])
    assert tried[-1][1] == round(est["step_peak_bytes"] / GIB, 2)


@pytest.mark.parametrize("n_layers", [1, 12, 24, 30, 36])
def test_h100_train_plan_runs_no_remat_until_it_must(n_layers):
    """qwen3-8b cut to ``n_layers``: the plan runs without remat while no
    remat's estimate fits, and with ``full`` beyond; never
    ``dots_saveable``, which ties with ``full``'s peak and ran slower on
    the card (PERF.md §6)."""
    plan = _train_plan(n_layers)
    est = plan.estimates
    _, tried = _rungs_tried(plan)
    none_fits = tried[0][1] <= est["step_budget_bytes"] / GIB
    assert tried[0][0] == "none"
    assert plan.comm.remat_policy == ("none" if none_fits else "full")
    assert len(tried) == (1 if none_fits else 2)
    assert est["step_fits"] == 1.0


def test_h100_train_plan_at_24_layers_covers_the_measured_peak():
    """At 24 layers the eager step peaked at 52.15 GiB on the card (remat
    none; PERF.md §6): the estimate is not below it, and no remat is
    needed."""
    plan = _train_plan(24)
    assert plan.comm.remat_policy == "none"
    assert plan.estimates["step_peak_bytes"] >= 52.15 * GIB
    assert plan.estimates["step_peak_bytes"] <= 1.15 * 52.15 * GIB


def test_step_peak_rises_without_remat_and_with_microbatches():
    """A tiny arch at 32k tokens a step (so its activations, not the
    optimizer's chunk, set the peak): the estimate rises as the remat
    policy drops from full to none, and microbatches > 1 add the fp32
    gradient sum (4 bytes a parameter on top of a microbatch's bf16)."""
    arch = tcfg.get_arch("qwen3-8b").reduced()
    shape = tcfg.ShapeConfig("t", "train", 2048, 16)
    plan = _train_plan(arch=arch, shape=shape)
    assert plan.comm.remat_policy == "none"          # a tiny step fits
    _, heads, _, kv = plan.padded_sizes()
    kw = dict(tokens=shape.tokens, heads=heads or arch.n_heads,
              kv_heads=kv or arch.n_kv_heads, vocab=arch.vocab_size,
              state_bytes=1e6, param_bytes=4e6, largest_stacked_bytes=1e6,
              embed_bytes=1e5)
    peaks = [tcm.eager_train_step_memory(arch, remat=r, **kw)["peak"]
             for r in LADDER]
    assert peaks == sorted(peaks, reverse=True) and peaks[0] > peaks[-1]
    one = tcm.eager_train_step_memory(arch, microbatches=1, remat="none",
                                      **kw)
    two = tcm.eager_train_step_memory(arch, microbatches=2, remat="none",
                                      **kw)
    assert two["grads"] == 3 * one["grads"]          # bf16 + the fp32 sum
    assert two["saved"] < one["saved"]               # half the tokens


def _saved_bytes(arch, remat, tokens_shape=(2, 64), cfg=None):
    """Bytes autograd keeps for one step of ``arch``'s training loop (a
    layer, or a super-block) on the CPU under ``remat``: the storages the
    saved-tensor hooks see that are still alive while the step's output
    is (parameters excluded; a saved tensor whose node died, such as that
    of an unused product, is freed)."""
    import weakref

    import torch

    from repro_torch.models import lm
    from repro_torch.optim import adamw
    params = lm.init_params(arch, torch.Generator().manual_seed(0))
    owned = set()
    for leaf in adamw.leaves(params):
        leaf.requires_grad_(leaf.is_floating_point())
        owned.add(leaf.untyped_storage().data_ptr())
    B, S = tokens_shape
    x = torch.randn(B, S, arch.d_model).to(torch.bfloat16).requires_grad_()
    positions = torch.arange(S).expand(B, S)
    if arch.mrope_sections is not None:         # M-RoPE: three streams
        positions = positions.expand(3, B, S)
    owned.add(positions.untyped_storage().data_ptr())
    step = lm.layer_groups(arch, params["blocks"])[0]
    seen = []

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in owned:
            seen.append((st.data_ptr(), st.nbytes(), weakref.ref(t)))
        return t

    cfg = cfg or lm.RunCfg()
    block = lm._remat(lambda *a: lm._group_fwd(arch, cfg, *a), remat)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = block(step, x, positions, (0, 0))
    alive = {p: n for p, n, ref in seen if ref() is not None}
    del out
    return sum(alive.values()), B * S


@pytest.mark.parametrize("remat", LADDER)
def test_layer_estimate_is_what_autograd_keeps(remat):
    """The per-layer term of the estimate against what PyTorch keeps for
    one layer of the reduced qwen3 (qk-norm, RoPE, gated FFN) at its
    published head_dim, byte for byte."""
    arch = dataclasses.replace(tcfg.get_arch("qwen3-8b").reduced(),
                               head_dim=128)
    got, tokens = _saved_bytes(arch, remat)
    want = tcm.eager_layer_saved_bytes(arch, tokens, arch.n_heads,
                                       arch.n_kv_heads, remat)
    assert got == want


#: (arch, MoE path): the families training reaches beyond the dense
#: decoders; llama4's step is a [dense, MoE] super-block
FAMILIES = [("mamba2-2.7b", ""), ("hymba-1.5b", ""),
            ("granite-moe-1b-a400m", "dense_einsum"),
            ("granite-moe-1b-a400m", "gshard_einsum"),
            ("llama4-maverick-400b-a17b", "dense_einsum"),
            ("llama4-maverick-400b-a17b", "gshard_einsum"),
            ("qwen2-vl-72b", ""), ("hubert-xlarge", "")]


@pytest.mark.parametrize("remat", LADDER)
@pytest.mark.parametrize("name,impl", FAMILIES,
                         ids=[f"{n}-{i}" if i else n for n, i in FAMILIES])
def test_family_step_estimate_is_what_autograd_keeps(name, impl, remat):
    """The estimate's per-step term for the SSM mixer (the scan's
    inputs, ``y``, final and chunk states kept by ``SSDScan``), the
    hybrid's two paths, each MoE path (with llama4's shared expert),
    qwen2-vl's M-RoPE layer and hubert's encoder layer (non-causal
    attention without RoPE, the GELU FFN),
    against what PyTorch keeps on the CPU, byte for byte: 2 x 64 tokens,
    the SSD chunk 16 (four chunks a sequence)."""
    from repro_torch.models import lm
    arch = tcfg.get_arch(name).reduced()
    cfg = lm.RunCfg(moe_impl=impl or "gshard_einsum", ssd_chunk=16)
    got, tokens = _saved_bytes(arch, remat, cfg=cfg)
    want = sum(tcm.eager_layer_saved_bytes(
        arch, tokens, arch.n_heads, arch.n_kv_heads, remat, seqs=2, ffn=f,
        ssd_chunk=16) for f in tcm.layer_group_ffns(arch, impl)) \
        if remat == "none" else tcm.eager_layer_saved_bytes(
            arch, tokens, arch.n_heads, arch.n_kv_heads, remat)
    assert got == want


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_family_step_estimate_counts_the_ssd_workspace(name):
    """With an SSM the turn holds the larger of the loss's region and the
    SSD backward's workspace (``bwd_workspace_floats``, fp32, at the
    plan's chunk 256; its dC slots are 7 row tiles a chunk for 4):
    byte for byte at the full width, 2048 x 1.  At the real vocab the
    loss's region is larger; with a vocab of 8 the workspace sets the
    turn."""
    from repro_torch.kernels import ssd_scan as tssd
    arch = tcfg.get_arch(name)
    kw = dict(tokens=2048, heads=arch.n_heads or 1,
              kv_heads=arch.n_kv_heads or 1, state_bytes=0.0,
              param_bytes=0.0, largest_stacked_bytes=0.0, embed_bytes=0.0,
              remat="full")
    est = tcm.eager_train_step_memory(arch, vocab=arch.vocab_size, **kw)
    ws = 4 * tssd.bwd_workspace_floats(
        1, 2048, arch.ssm_heads, arch.ssm_head_dim, arch.ssm_state,
        arch.ssm_n_groups, 256)
    assert est["ssd_workspace"] == ws
    assert tssd.bwd_slots(256) == 7
    assert est["loss"] > ws
    small = tcm.eager_train_step_memory(arch, vocab=8, **kw)
    assert small["peak"] == (small["state"] + small["runtime"]
                             + max(small["saved"] + ws,
                                   small["grads"] + small["tail"]))


#: content hash prefixes of the plans whose estimate the families' terms
#: leave as they were: qwen3-8b's h100-sxm train plan (2048 x 1)
H100_TRAIN_HASHES = {"qwen3-8b": "0d26648d7bf6d690"}


@pytest.mark.parametrize("name", sorted(H100_TRAIN_HASHES))
def test_h100_dense_train_plan_is_unchanged(name):
    assert _train_plan(arch=tcfg.get_arch(name)).content_hash()[:16] == \
        H100_TRAIN_HASHES[name]


@pytest.mark.parametrize("name,remat,estimate_gib", [
    ("granite-moe-1b-a400m", "none", 37.94), ("mamba2-2.7b", "full", 43.76),
    ("hymba-1.5b", "none", 38.56)])
def test_h100_family_train_plans_fit_the_card(name, remat, estimate_gib):
    """The three families' full-width, full-depth train plans (2048 x 1):
    granite's picks ``dense_einsum`` and, like hymba's, no remat;
    mamba2's estimate without remat (72.13 GiB) is over the budget, so
    ``full``.  Each fits; the estimate is the one the plan logs."""
    plan = _train_plan(arch=tcfg.get_arch(name))
    est = plan.estimates
    assert plan.comm.remat_policy == remat and est["step_fits"] == 1.0
    assert round(est["step_peak_bytes"] / GIB, 2) == estimate_gib
    if name.startswith("granite"):
        assert est["moe_impl"] == "dense_einsum"
