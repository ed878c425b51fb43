"""Plan parity: the port's specialization flow against the JAX package's.

The flow is pure Python in both packages, so under the same target the
port must produce the very same frozen plan (equal content hashes) for
every runnable cell.  The H100 target then plans the chip-smoke shape
for one card.
"""

import dataclasses

import pytest

import repro.configs as rcfg
import repro.core as rcore
import repro_torch.configs as tcfg
import repro_torch.core as tcore
from repro_torch.hw import get_target
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa

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


def test_tpu_v5e_plans_a_one_sequence_grant_pool_for_full_qwen3():
    """Why the port needs a card target: on v5e the 16 GiB of
    weights leave room for one sequence, and the pool is a grant pool."""
    plan = tcore.specialize(tcfg.get_arch("qwen3-8b"),
                            tcfg.ShapeConfig("serve_h100", "decode", 2048, 8),
                            mesh_shape=(1, 1), target="tpu-v5e")
    assert plan.estimates["kv_admission"] == "grant"
    assert plan.estimates["kv_n_blocks"] == 8
