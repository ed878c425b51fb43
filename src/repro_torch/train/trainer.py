"""Training loop: the plan-lowered step, the pipeline, checkpoints.

The port of ``repro/train/trainer.py``.  Everything configurable arrives
through the frozen plan (the paper's flow output); the trainer is glue:

    plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm")
    trainer = Trainer(plan, device="cuda")
    state, metrics = trainer.fit()

The plan ships with the model: the trainer stores the artifact
content-addressed beside the checkpoints (``<ckpt_dir>/plans``) and
stamps every checkpoint manifest with its hash.  A restarted job
warm-starts from the stored artifact (:meth:`Trainer.warm_start`)
without re-running the compiler; if the hash moved, :meth:`Trainer
.resume` prints the diff of the two decision logs.

The port trains on one card: ``mesh`` must be ``None`` (training on a
mesh is ROADMAP item 10b), and ``device`` names the card, or the CPU
(the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs.base import get_arch, get_shape
from repro_torch.core import planstore
from repro_torch.core.passes.lowering import LoweredStep, lower_train_step
from repro_torch.core.plan import diff_decision_logs
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticSource, \
    to_device
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.straggler import StepTimer


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "build/ckpt"
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, plan, mesh=None, cfg: Optional[TrainerConfig] = None,
                 opt_cfg: Optional[adamw.OptConfig] = None,
                 arch=None, shape=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer: the port trains on one card (mesh=None); a mesh "
                "(FSDP / data parallelism) waits for ROADMAP item 10b")
        self.plan = plan
        self.cfg = cfg or TrainerConfig()
        self.device = torch.device(device)
        # reduced/custom configs are passed explicitly; registry by default
        self.arch = arch if arch is not None else get_arch(plan.arch)
        self.shape = shape if shape is not None else get_shape(plan.shape)
        self.step_def: LoweredStep = lower_train_step(
            plan, self.arch, self.shape, None, opt_cfg)
        self.step_fn = self.step_def.fn
        self.opt_cfg = opt_cfg or adamw.OptConfig.from_plan(plan)
        self.ckpt = Checkpointer(self.cfg.ckpt_dir)
        self.timer = StepTimer()
        self.history: list = []
        # the plan artifact ships with the checkpoints
        self.plan_store = planstore.get_store(
            Path(self.cfg.ckpt_dir) / "plans")
        self.plan_hash = plan.content_hash()
        self.plan_store.save(plan)

    # ------------------------------------------------------------------
    @classmethod
    def warm_start(cls, ckpt_dir, mesh=None,
                   cfg: Optional[TrainerConfig] = None,
                   opt_cfg: Optional[adamw.OptConfig] = None,
                   arch=None, shape=None, device="cuda") -> "Trainer":
        """Rebuild a trainer from a checkpoint directory's stored plan.

        Reads the latest manifest's ``plan_hash`` and reloads the frozen
        artifact from ``<ckpt_dir>/plans`` (no compiler run); when it is
        missing or corrupt, re-specializes from the caller's
        ``arch``/``shape`` (else the manifest's names) on the manifest's
        target (:meth:`resume` then shows any hash drift)."""
        ckpt = Checkpointer(ckpt_dir)
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        meta = ckpt.manifest(step).get("meta", {})
        store = planstore.get_store(Path(ckpt_dir) / "plans")
        plan = store.load(meta["plan_hash"]) if meta.get("plan_hash") \
            else None
        if plan is None:
            from repro_torch.core.pipeline import specialize
            arch_src = arch if arch is not None else meta.get("arch")
            shape_src = shape if shape is not None else meta.get("shape")
            if arch_src is None or shape_src is None:
                raise FileNotFoundError(
                    f"warm_start: no plan artifact in {ckpt_dir}/plans and "
                    f"the step_{step:08d} manifest has no usable metadata; "
                    f"pass arch=/shape= to recompile")
            print(f"warm_start: plan artifact missing in {ckpt_dir}/plans; "
                  f"re-running the specialization flow", flush=True)
            plan = specialize(arch_src, shape_src, mesh_shape=(1, 1),
                              target=meta.get("plan_target", "h100-sxm"),
                              use_pallas=meta.get("plan_use_pallas", "auto"))
        cfg = dataclasses.replace(cfg or TrainerConfig(),
                                  ckpt_dir=str(ckpt_dir))
        return cls(plan, mesh, cfg, opt_cfg=opt_cfg, arch=arch, shape=shape,
                   device=device)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Parameters from a generator on the trainer's device seeded
        with ``seed``, at the plan's padded sizes, and the optimizer
        state the plan asks for."""
        gen = torch.Generator(self.device).manual_seed(seed)
        params = lm.init_params(self.arch, gen, *self.plan.padded_sizes())
        return self.place({"params": params,
                           "opt": adamw.init_opt_state(params,
                                                       self.opt_cfg)})

    def place(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """``state`` on the trainer's device, its float parameters leaves
        that require grad (the step differentiates with respect to them);
        the optimizer's step counter stays on the host."""
        def param(t):
            t = t.detach().to(self.device)
            return t.requires_grad_(t.is_floating_point())

        opt = dict(state["opt"])
        step = opt.pop("step")
        opt = adamw.map_leaves(opt, lambda t: t.detach().to(self.device))
        opt["step"] = torch.as_tensor(step, dtype=torch.int32).cpu()
        return {"params": adamw.map_leaves(state["params"], param), "opt": opt}

    def fit(self, state: Optional[Dict[str, Any]] = None,
            n_steps: Optional[int] = None, start_step: int = 0):
        """Train from ``state`` (default: :meth:`init_state`) over the
        pipeline's steps ``start_step..n_steps-1``; returns ``(state,
        metrics)``.  The step updates the state **in place** (where the
        reference donates it): a caller that needs the starting state
        again passes a copy."""
        n_steps = n_steps or self.cfg.n_steps
        state = (self.place(state) if state is not None
                 else self.init_state(self.cfg.seed))
        source = SyntheticSource(self.arch, self.shape, seed=self.cfg.seed)
        pipe = PrefetchPipeline(source, self.plan.comm.prefetch_depth,
                                start_step=start_step,
                                device_put=to_device(self.device))
        metrics: Dict[str, Any] = {}
        try:
            for step, batch in pipe:
                if step >= n_steps:
                    break
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])   # sync point
                gnorm = float(metrics["grad_norm"])
                dt = time.perf_counter() - t0
                self.timer.observe(dt)
                self.history.append({"step": step, "loss": loss,
                                     "grad_norm": gnorm,
                                     "lr": float(metrics["lr"]),
                                     "dt_s": dt})
                if step % self.cfg.log_every == 0:
                    print(f"step {step:6d} loss {loss:8.4f} "
                          f"{dt * 1e3:7.1f} ms gnorm {gnorm:.3f} "
                          f"lr {float(metrics['lr']):.3e}", flush=True)
                if self.cfg.ckpt_every and \
                        (step + 1) % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step + 1, state,
                                   meta={"arch": self.arch.name,
                                         "shape": self.shape.name,
                                         "plan_hash": self.plan_hash,
                                         "plan_target": self.plan.target,
                                         "plan_use_pallas":
                                             self.plan.use_pallas})
        finally:
            pipe.close()
            self.ckpt.wait()
        return state, metrics

    def resume(self):
        """``(state, step)`` of the latest checkpoint, on the trainer's
        device.  A checkpoint whose ``plan_hash`` differs from this
        trainer's plan was lowered under other decisions: the diff of
        the two decision logs is printed, and the restore proceeds."""
        state, manifest = self.ckpt.restore(device=self.device)
        saved_hash = manifest.get("meta", {}).get("plan_hash", "")
        if saved_hash and saved_hash != self.plan_hash:
            print(f"resume: plan hash changed "
                  f"{saved_hash[:12]} -> {self.plan_hash[:12]} "
                  f"(recompiled under different decisions)", flush=True)
            old = self.plan_store.load(saved_hash)
            if old is not None:
                for line in diff_decision_logs(old.log, self.plan.log):
                    print(f"  plan diff: {line}", flush=True)
        return self.place(state), manifest["step"]
