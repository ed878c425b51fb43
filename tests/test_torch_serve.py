"""Engine parity: the port's ServeEngine against the JAX package's.

Both engines are built ``from_plan`` on the ``serve_demo`` plan
(reduced qwen3-8b, decode 128 x 4, target tpu-v5e — the plan
``examples/serve_batch.py`` serves) with prefix reuse and the host tier
overridden off, on the same weights, and serve the same 10 greedy
requests.  The port runs its kernels' plain versions (CPU tensors).

Greedy tokens must be identical wherever the reference's top-2 logit
margin exceeds the logit tolerance (2e-2 of the logits' largest
magnitude, the bf16 tolerance of ``test_torch_model.py``); past a step
whose margin is inside it, the two runs may part ways and the rest of
that request is not compared.  Pool accounting and prefill batching
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.core.passes.lowering import build_run_cfg as rbuild_run_cfg
from repro.models import lm as rlm
from repro.serve.allocator import BlockAllocator as RAlloc
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.models import convert
from repro_torch.serve.allocator import BlockAllocator as TAlloc
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 2e-2
PROMPT_LENS = (12, 20, 33)      # few lengths, so admission buckets batch


def _requests():
    rng = np.random.default_rng(0)
    lens = rng.choice(PROMPT_LENS, size=10)
    return [rng.integers(0, 512, (int(n),)).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def served():
    rarch = rget_arch("qwen3-8b").reduced()
    tarch = tget_arch("qwen3-8b").reduced()
    rplan = rspecialize(rarch, RShape("serve_demo", "decode", 128, 4),
                        mesh_shape=(1, 1))
    tplan = tspecialize(tarch, TShape("serve_demo", "decode", 128, 4),
                        mesh_shape=(1, 1), target="tpu-v5e")
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *rplan.padded_sizes())
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    over = {"kv_prefix_reuse": "off", "kv_host_blocks": 0}
    reng = RServeEngine.from_plan(rplan, rparams, arch=rarch, **over)
    teng = TServeEngine.from_plan(tplan, tparams, arch=tarch, **over)
    assert teng.kv_residency == reng.kv_residency == "paged"
    prompts = _requests()
    for eng in (reng, teng):
        for p in prompts:
            eng.submit(p, max_new_tokens=12, temperature=0.0)
    rdone = {r.rid: r for r in reng.run_until_idle()}
    tdone = {r.rid: r for r in teng.run_until_idle()}
    return {"rarch": rarch, "rparams": rparams,
            "rcfg": rbuild_run_cfg(rplan, rarch, None), "reng": reng,
            "teng": teng, "rdone": rdone, "tdone": tdone, "prompts": prompts}


def _margin(s, prompt, out, i) -> float:
    """The reference's top-1 minus top-2 logit before output token
    ``i``, relative to the logits' largest magnitude."""
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(s["rarch"], s["rparams"],
                            {"tokens": jnp.asarray(toks[None])}, s["rcfg"])
    lf = np.asarray(logits[0, :s["rarch"].vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


def test_greedy_tokens_match_where_the_margin_allows(served):
    s = served
    assert sorted(s["tdone"]) == sorted(s["rdone"]) == list(range(10))
    compared = 0
    for rid, r in s["rdone"].items():
        got, want = s["tdone"][rid].out_tokens, r.out_tokens
        assert len(got) == len(want) == 12
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                m = _margin(s, s["prompts"][rid], want, i)
                assert m <= TOL, (rid, i, a, b, m)
                break
            compared += 1
    assert compared >= 100          # nearly every token was held equal


def test_pool_accounting_and_prefill_batching_match(served):
    reng, teng = served["reng"], served["teng"]
    assert teng.block_stats() == reng.block_stats()
    assert teng.prefill_calls == reng.prefill_calls
    assert list(teng.prefill_batches) == list(reng.prefill_batches)
    assert max(teng.prefill_batches) > 1        # a bucket really batched
    assert teng.tick == reng.tick
    tel = teng.telemetry()
    assert tel["decode_path"] == "paged_decode_attention:plain"
    assert tel["kernel_launches"] == {"flash_attention": 0,
                                      "paged_decode_attention": 0,
                                      "decode_attention": 0}


def test_from_plan_refuses_what_the_port_cannot_honour():
    arch = tget_arch("qwen3-8b")
    grant = tspecialize(arch, TShape("serve_h100", "decode", 2048, 8),
                        mesh_shape=(1, 1), target="tpu-v5e")
    assert grant.estimates["kv_admission"] == "grant"
    with pytest.raises(NotImplementedError, match="kv_admission"):
        TServeEngine.from_plan(grant, {}, kv_prefix_reuse="off",
                               kv_host_blocks=0)
    demo = tspecialize(arch.reduced(), TShape("serve_demo", "decode", 128, 4),
                       mesh_shape=(1, 1), target="tpu-v5e")
    assert demo.estimates["kv_prefix_reuse"] == "on"
    with pytest.raises(NotImplementedError, match="kv_prefix_reuse"):
        TServeEngine.from_plan(demo, {}, arch=arch.reduced(),
                               kv_host_blocks=0)
    with pytest.raises(NotImplementedError, match="kv_host_blocks"):
        TServeEngine.from_plan(demo, {}, arch=arch.reduced(),
                               kv_prefix_reuse="off")
    meshed = tspecialize(arch.reduced(), TShape("serve_demo", "decode", 128,
                                                4), mesh_shape=(2, 2),
                         target="tpu-v5e")
    with pytest.raises(NotImplementedError, match="mesh"):
        TServeEngine.from_plan(meshed, {}, arch=arch.reduced(),
                               kv_prefix_reuse="off", kv_host_blocks=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_block_allocator_matches_reference_op_for_op(seed):
    """The port's pure-Python allocator copy against the reference's on
    one seeded stream of allocate / retain / release: the same ids, the
    same freed lists and the same stats after every operation."""
    rng = np.random.default_rng(seed)
    ra, ta = RAlloc(24, 2), TAlloc(24, 2)
    held = []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0 or not held:
            need, group = int(rng.integers(1, 5)), int(rng.integers(0, 2))
            got = ta.allocate(need, group)
            assert got == ra.allocate(need, group)
            if got is not None:
                held.append(list(got))
        elif op == 1:
            blocks = held[int(rng.integers(0, len(held)))]
            ta.retain(blocks)
            ra.retain(blocks)
            held.append(list(blocks))
        else:
            blocks = held.pop(int(rng.integers(0, len(held))))
            assert ta.release(blocks) == ra.release(blocks)
        assert ta.stats() == ra.stats()
