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

``device`` names the card, or the CPU (the kernels' plain versions).
With a ``mesh`` (a ``(data, model)`` ``DeviceMesh`` over the process
group) every rank builds only its pieces of the state the seed gives
(``lm.init_params(pieces=)``), runs the mesh step
(:func:`repro_torch.core.passes.lowering.lower_train_step`) on the
global batch the source draws (the step cuts the rank's rows, so every
mesh sees the data one card sees), and checkpoints keep the reference's
whole-leaf layout: :meth:`Trainer.save` gathers whole leaves to the
mesh's first rank, which alone writes (the wire's EF residuals stacked
``(dp, ...)`` as the reference keeps them), and :meth:`Trainer.resume`
cuts this mesh's pieces from them, so a checkpoint of one mesh resumes
on another.  A mesh built for one device type never runs on another.
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
from repro_torch.dist.collectives import ef_state
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
        self.plan = plan
        self.mesh = mesh
        self.cfg = cfg or TrainerConfig()
        self.device = torch.device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"Trainer: a mesh built for {mesh.device_type!r} cannot "
                f"train on {self.device}")
        # reduced/custom configs are passed explicitly; registry by default
        self.arch = arch if arch is not None else get_arch(plan.arch)
        self.shape = shape if shape is not None else get_shape(plan.shape)
        self.step_def: LoweredStep = lower_train_step(
            plan, self.arch, self.shape, mesh, opt_cfg)
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
            plan = specialize(arch_src, shape_src,
                              mesh_axes=("data", "model"),
                              mesh_shape=(tuple(mesh.shape) if mesh is not None
                                          else (1, 1)),
                              target=meta.get("plan_target", "h100-sxm"),
                              use_pallas=meta.get("plan_use_pallas", "auto"))
        cfg = dataclasses.replace(cfg or TrainerConfig(),
                                  ckpt_dir=str(ckpt_dir))
        return cls(plan, mesh, cfg, opt_cfg=opt_cfg, arch=arch, shape=shape,
                   device=device)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Parameters from a generator on the trainer's device seeded
        with ``seed``, at the plan's padded sizes (on a mesh the rank's
        pieces of them), and the optimizer state the plan asks for:
        with gradient compression a zero bf16 residual a leaf."""
        gen = torch.Generator(self.device).manual_seed(seed)
        pieces = None
        if self.mesh is not None:
            from repro_torch.serve.sharded import param_pieces
            pieces = param_pieces(self.mesh, self.plan, self.arch)
        params = lm.init_params(self.arch, gen, *self.plan.padded_sizes(),
                                pieces=pieces)
        opt = adamw.init_opt_state(params, self.opt_cfg)
        if self.step_def.ef:
            opt["ef"] = ef_state(params)
        return self.place({"params": params, "opt": opt})

    def place(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """``state`` on the trainer's device, its float parameters leaves
        that require grad (the step differentiates with respect to them);
        the optimizer's step counter stays on the host."""
        def param(t):
            t = t.detach().to(self.device)
            return t.requires_grad_(t.is_floating_point())

        opt = dict(state["opt"])
        step = opt.pop("step")
        opt = adamw.tree_map(lambda t: t.detach().to(self.device), opt)
        opt["step"] = torch.as_tensor(step, dtype=torch.int32).cpu()
        return {"params": adamw.tree_map(param, state["params"]), "opt": opt}

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
                    self.save(step + 1, state)
        finally:
            pipe.close()
            self.ckpt.wait()
        return state, metrics

    def save(self, step: int, state: Dict[str, Any],
             blocking: bool = False) -> None:
        """Checkpoint ``state`` at ``step`` in the reference's layout: on
        a mesh every rank joins the gathers of whole leaves and the
        mesh's first rank writes them."""
        meta = {"arch": self.arch.name, "shape": self.shape.name,
                "plan_hash": self.plan_hash,
                "plan_target": self.plan.target,
                "plan_use_pallas": self.plan.use_pallas}
        if self.mesh is None:
            self.ckpt.save(step, state, meta=meta, blocking=blocking)
            return
        writer = all(c == 0 for c in self.mesh.get_coordinate())
        whole = whole_state(state, self.step_def, keep=writer)
        if writer:
            self.ckpt.save(step, whole, meta=meta, blocking=blocking)

    def resume(self):
        """``(state, step)`` of the latest checkpoint, on the trainer's
        device.  On a mesh each whole leaf is read to the host and only
        this rank's piece of it goes to the device (:func:`cut_leaf`).
        A checkpoint whose ``plan_hash`` differs from this trainer's
        plan was lowered under other decisions: the diff of the two
        decision logs is printed, and the restore proceeds."""
        sd = self.step_def
        if self.mesh is None:
            state, manifest = self.ckpt.restore(device=self.device)
            ef = state["opt"].pop("ef", None)
            if sd.ef and ef is not None:
                state["opt"]["ef"] = adamw.tree_map(
                    lambda e, p: _residual(e, p.dim(), sd), ef,
                    state["params"])
        else:
            state, manifest = self.ckpt.restore(
                device="cpu",
                take=lambda key, t: cut_leaf(key, t, sd, self.device))
        if sd.ef and "ef" not in state["opt"]:
            state["opt"]["ef"] = ef_state(state["params"])
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


def whole_state(state: Dict[str, Any], step: LoweredStep,
                keep: bool = True) -> Dict[str, Any]:
    """The state's whole leaves from every rank's pieces, on the host
    (each dim gathered over its spec's axes, data-major, one leaf at a
    time, so a rank's device holds one whole leaf at most); the wire's
    EF leaves stacked over the data ranks, ``(dp, ...)``.  Every rank
    joins the gathers; with ``keep`` false it drops what it gathered
    (``None`` leaves)."""
    from repro_torch.dist import fsdp
    from repro_torch.dist.collectives import all_gather, axes_groups
    lay = step.layout

    def whole(t, spec, stack=False):
        t = fsdp.whole(t.detach(), spec, lay.mesh)
        if stack:
            t = all_gather(t[None], 0, axes_groups(lay.mesh, lay.batch_axes))
        return t.cpu() if keep else None

    out = {"params": adamw.tree_map(whole, state["params"], lay.specs),
           "opt": {}}
    for k, v in state["opt"].items():
        out["opt"][k] = v if k == "step" else adamw.tree_map(
            lambda t, spec: whole(t, spec, k == "ef" and step.wire_dp),
            v, lay.specs)
    return out


def _residual(e: torch.Tensor, pdim: int, step: LoweredStep
              ) -> torch.Tensor:
    """A checkpoint's EF residual of a ``pdim``-dim leaf in the layout
    ``step`` keeps: a stacked ``(r, ...)`` one (the reference's wire)
    becomes this rank's row where ``step``'s wire has ``r`` data ranks,
    else the rows' mean (what the ``r`` slices still owe: the
    telescoping identity's term)."""
    if e.dim() != pdim + 1:
        return e
    if step.wire_dp and e.shape[0] == step.wire_dp:
        return e[step.layout.batch_index]
    return e.float().mean(0).to(e.dtype)


def cut_leaf(key: str, t: torch.Tensor, step: LoweredStep, device
             ) -> Optional[torch.Tensor]:
    """This rank's piece, on ``device``, of the checkpoint's whole leaf
    ``key`` (its flat ``a/b/c`` name): the reference's "resharded for
    this mesh".  An EF residual goes through :func:`_residual` first;
    ``None`` where ``step`` keeps no residuals."""
    from repro_torch.dist.sharding import local_shard
    top, *path = key.split("/")
    kind = path.pop(0) if top == "opt" else top
    if kind == "step":
        return t
    if kind == "ef" and not step.ef:
        return None
    lay = step.layout
    spec, whole = lay.specs, lay.whole
    for k in path:
        spec, whole = spec[k], whole[k]
    if kind == "ef":
        t = _residual(t, len(whole), step)
    return local_shard(t, lay.mesh, spec).to(device)
