"""Host-side training schedule: loss-weight annealing, the l1 -> l2 rgb
switch, LR decay and the PSNR-plateau auto-scheduler.

Port of ``nope_nerf_tpu/training/scheduler.py`` (numpy only, copied rather
than imported: the JAX package's ``training`` module imports jax, which the
port's machine does not have). Outputs are plain floats the step reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WEIGHT_NAMES = (
    "rgb_weight",
    "depth_weight",
    "pc_weight",
    "rgb_s_weight",
    "depth_consistency_weight",
    "weight_dist_2nd_loss",
    "weight_dist_1st_loss",
)


def anneal(start_weight, end_weight, anneal_start_epoch, anneal_epochs, current):
    """`model/training.py:187-195`."""
    if current <= anneal_start_epoch:
        return float(start_weight)
    if current >= anneal_start_epoch + anneal_epochs:
        return float(end_weight)
    return float(
        start_weight
        + (end_weight - start_weight)
        * (current - anneal_start_epoch)
        / anneal_epochs
    )


@dataclass
class ScheduleState:
    """Checkpointable scheduler scalars (reference resumes these too,
    `train.py:70-75`)."""

    epoch_it: int = -1
    it: int = -1
    metric_val_best: float = -np.inf
    patient_count: int = 0
    scheduling_start: int = 10000
    psnr_window: list = field(default_factory=list)

    def to_dict(self):
        return {
            "epoch_it": self.epoch_it,
            "it": self.it,
            "loss_val_best": self.metric_val_best,
            "patient_count": self.patient_count,
            "scheduling_start": self.scheduling_start,
        }


class Scheduler:
    """Produces per-epoch weights / lrs and runs the plateau detector."""

    def __init__(self, cfg, state: ScheduleState | None = None):
        t = cfg["training"]
        self.cfg = cfg
        self.auto = t["auto_scheduler"]
        self.annealing_epochs = t["annealing_epochs"]
        self.length_smooth = t["length_smooth"]
        self.patient = t["patient"]
        self.scheduling_epoch = t["scheduling_epoch"]
        self.base_lrs = {
            "nerf": t["learning_rate"],
            "pose": t["pose_lr"],
            "focal": t["focal_lr"],
            "distortion": t["distortion_lr"],
        }
        self.gammas = {
            "nerf": t["scheduler_gamma"],
            "pose": t["scheduler_gamma_pose"],
            "focal": t["scheduler_gamma_focal"],
            "distortion": t["scheduler_gamma_distortion"],
        }
        self.decay_every = {"nerf": 10, "pose": 100, "focal": 100,
                            "distortion": 100}
        self.initial_rgb_loss_type = t.get("rgb_loss_type", "l1")
        self.state = state or ScheduleState(
            scheduling_start=t["scheduling_start"]
        )
        if state is None:
            self.state.scheduling_start = t["scheduling_start"]
        self.weight_pairs = {name: t[name] for name in WEIGHT_NAMES}

    @property
    def total_epochs(self):
        return self.state.scheduling_start + self.scheduling_epoch

    def weights(self, epoch):
        s = self.state.scheduling_start
        return {
            name: anneal(pair[0], pair[1], s, self.annealing_epochs, epoch)
            for name, pair in self.weight_pairs.items()
        }

    def rgb_loss_switch(self, epoch):
        """-> (w_l1, w_l2) (`model/training.py:211`).

        The pre-switch phase honors the configured ``rgb_loss_type`` (the
        reference hardcodes 'l1' there, leaving its config key dead; every
        shipped config sets 'l1', so this is behavior-identical for them).
        The post-switch phase is always l2, as in the reference.
        """
        if epoch < self.annealing_epochs + self.state.scheduling_start:
            return (0.0, 1.0) if self.initial_rgb_loss_type == "l2" else (1.0, 0.0)
        return 0.0, 1.0

    def lrs(self, epoch):
        """The decay formula evaluated at ``epoch`` (`train.py:326-340`) —
        what the reference LOGS as ``train/lr`` at the end of that epoch.
        For the LRs a given epoch's steps actually train at, use
        :meth:`applied_lrs`."""
        s = self.state.scheduling_start
        if epoch < s:
            return dict(self.base_lrs)
        return {
            g: self.base_lrs[g]
            * self.gammas[g] ** int((epoch - s) / self.decay_every[g])
            for g in self.base_lrs
        }

    def applied_lrs(self, epoch):
        """The LRs the reference APPLIES to epoch ``epoch``'s train steps.

        The reference rewrites the optimizer param_groups at the END of
        each epoch (`train.py:297-340`), so epoch E trains at values
        computed at epoch E-1 — with ``scheduling_start`` as of then, i.e.
        call this BEFORE feeding epoch E's PSNR to :meth:`update_plateau`.
        Executed A/B: tests/test_traincli_reference_exec.py reads the live
        torch ``param_groups`` at every real ``train_step`` of a full
        reference ``train()`` run and pins both paths:

        * auto path: the :meth:`lrs` formula at E-1 (`train.py:326-340`);
        * non-auto path: torch's ``LRScheduler.__init__`` runs one
          ``step()`` at construction, so after the end-of-epoch ``step()``
          of epoch e the counter reads e+1 and the milestone at m fires at
          the end of epoch m-1 — i.e. DURING epoch m. Epoch E has seen
          ``|{m in range(s, s+scheduling_epoch, k) : m <= E}|`` decays —
          one decade AHEAD of the auto path's int((E-1-s)/k) at every
          boundary (`train.py:77-81,107-110`; the same construction-time
          step the pose-opt A/B pinned for its MultiStepLR).
        """
        if self.auto:
            return self.lrs(epoch - 1)
        s = self.state.scheduling_start
        out = {}
        for g, k in self.decay_every.items():
            total = -(-self.scheduling_epoch // k)  # len(range(s, s+E, k))
            hit = 0 if epoch < s else min((epoch - s) // k + 1, total)
            out[g] = self.base_lrs[g] * self.gammas[g] ** hit
        return out

    def update_plateau(self, epoch, psnr):
        """Feed the per-epoch train PSNR; may set scheduling_start
        (`train.py:309-319`). Returns True when the phase just switched.

        Mirrors the reference exactly: the rewrite happens whenever
        ``patient_count`` REACHES ``patient`` — even at an epoch past the
        configured ``scheduling_start``, where it moves the phase switch
        FORWARD and extends the run (the ``==`` check makes it fire at
        most once either way)."""
        if not self.auto:
            return False
        st = self.state
        st.psnr_window.append(float(psnr))
        if len(st.psnr_window) >= self.length_smooth:
            st.psnr_window = st.psnr_window[-self.length_smooth:]
            metric_val = float(np.mean(st.psnr_window))
            if metric_val - st.metric_val_best >= 0:
                st.metric_val_best = metric_val
            else:
                st.patient_count += 1
                if st.patient_count == self.patient:
                    st.scheduling_start = epoch
                    return True
        return False

    def static_flags(self, epoch):
        """Structural switches of the step: which loss branches it builds
        (reference: `model/training.py:216-217`)."""
        w = self.weights(epoch)
        return {
            "render_model": (w["rgb_weight"] != 0.0) or (w["depth_weight"] != 0.0),
            "use_ref": (w["pc_weight"] != 0.0) or (w["rgb_s_weight"] != 0.0),
            "use_rgb_s": w["rgb_s_weight"] != 0.0,
        }
