"""Scoring by the published protocol: ``runtime/shape_engine.score_batch`` in
the final posture (the dense ``(vox + 1)^3`` decode, the exhaustive
best-of-rotations search), on batches drawn from a pool of analytic views
with their ground-truth clouds. No result file and no dump is written.

Set-up is the reconstruction cell's (weights from the seed, the random
decoder calibrated on the reference, the pool rendered on the device) with
each object's ground-truth cloud; the evaluation options are
``config.eval_opt`` with the mix's ``eval`` section. The host batch holds the
images on the device and the poses, indices and clouds in host memory, as
the evaluation's loader hands them over. Each call scores one batch; it
ends in the copy of the metrics to the host.

The check runs the reference once the window has closed: the depth map,
the intrinsics and the dense grid's logits as the reconstruction cell
compares them; then, for each sample, the surface samples drawn again by
the plain sampler from the program's level grid with the protocol's
per-sample generator, found again in the scored cloud under one rotation
of the sphere; the search, held against the least Chamfer distance that
the reference's own search finds; each sample's normalised ground truth
worked out again from the pool's cloud and pose; and the accuracy,
completeness and F-scores worked out again from the two clouds the program
scored.
"""

import math
import time

import numpy as np
import torch

from zsbench import program, scenes, work
from zsbench.reference import search, surface
from zsbench.runners import fold, recon

SCORED_TOL = 1e-3  # a scored point farther than this (normalised units) from the reference's is wrong


class Runner(recon.Runner):
    def setup(self):
        m, dev = self.mix, self.device
        self.pool = scenes.make_pool(self.seed, self.opts["H"], m["pool_objects"], m["views_per_object"], dev,
                                     gt_points=m["gt_points"])
        self.host = {"pose_gt": self.pool["pose_gt"].cpu().numpy(), "points": self.pool["gt_points"].cpu().numpy()}
        state = self.calibrated_state()
        self.opt = program.eval_options(program.options(self.opts), **m["eval"])
        self.model = program.recon_model(program.build_graph(self.opt, state, dev), m["sharpen"], dev)
        del state
        self.order = scenes.draw_order(self.seed, self.pool["rgb_input_map"].shape[0], m["max_calls"], self.B)
        rng = np.random.default_rng(self.seed)
        self.keep_at = {0} | set(rng.integers(1, m["check_within"], m["check_calls"] - 1).tolist())
        self.calls, self.kept = 0, {}
        for _ in range(m["warmup_calls"]):
            self.call(keep=False)
        self.calls, self.kept = 0, {}

    def call(self, keep=True):
        rows = self.order[self.calls % len(self.order)]
        idx = torch.as_tensor(rows, device=self.device)
        batch = {k: self.pool[k][idx] for k in ("rgb_input_map", "mask_input_map")}
        batch.update(pose_gt=self.host["pose_gt"][rows], idx=np.asarray(rows), dpc={"points": self.host["points"][rows]})
        acc, comp, f, _, drawn = program.score_batch(self.model, batch, self.opt, training=False, keep=True)
        self.last = {"idx": idx, "depth": drawn["out"]["depth_pred"], "intr": drawn["out"]["intr_pred"],
                     "level": drawn["level"], "pred_n": drawn["pred_n"], "gt_n": drawn["gt_n"],
                     "acc": acc, "comp": comp, "f": f}
        if keep and self.calls in self.keep_at:
            self.kept[self.calls] = self.last
        self.calls += 1

    def window(self, seconds):
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < seconds:
            self.call()  # ends in the metrics' copy to the host
            calls += 1
        elapsed = time.perf_counter() - t0
        self.kept[self.calls - 1] = self.last
        return {"eval_samples_per_s": self.B * calls / elapsed}, calls

    # -- the check ----------------------------------------------------------
    def rotations(self):
        return search.rotation_sphere(*self.mix["rot_samples"], self.device)

    def gt_reference(self, row):
        """A sample's GT cloud in its view, normalised, from the pool's cloud and pose."""
        pose = self.pool["pose_gt"][row]
        return search.normalize(self.pool["gt_points"][row] @ pose[:, :3].T)

    def reference_samples(self, kept, cells):
        """The plain sampler's world points ``[B, P, 3]`` on the call's dense
        level grids, each sample with the protocol's generator for its row."""
        m = self.mix
        pts = []
        for b, row in enumerate(kept["idx"].tolist()):
            gen = torch.Generator(device=self.device).manual_seed(m["surface_seed"] * 2**32 + row)
            pts.append(surface.sample_dense(kept["level"][b].float(), gen, m["num_points"]))
        return surface.to_world(torch.stack(pts), m["vox_res"], m["range"])

    def check_samples(self, kept, cells):
        """Per sample: ``sample_gap``, the share of the scored cloud's points
        farther than ``SCORED_TOL`` from the plain sampler's points under the
        rotation of the sphere that brings them closest; ``search_gap``, by
        how much the program's CD exceeds the least that the reference's
        search finds (that rotation among its candidates), relative;
        ``gt_gap``, the scored GT against the pool's; ``cd_gap`` and
        ``fscore_gap``, the reported metrics against those worked out again
        from the two scored clouds."""
        rot = self.rotations()
        pw = self.reference_samples(kept, cells)
        thresholds = self.opt.eval.f_thresholds
        gaps = {}
        for b, row in enumerate(kept["idx"].tolist()):
            gt_r = self.gt_reference(row)
            gt_p, pred_p = kept["gt_n"][b].float(), kept["pred_n"][b].float()
            r_p, matched = search.closest_rotation(pw[b], pred_p, rot)
            acc, comp, acc_d, comp_d = search.chamfer(pred_p, gt_p)
            cd_r = float((acc + comp) / 2)
            cd_p = (float(kept["acc"][b]) + float(kept["comp"][b])) / 2
            best, _ = search.least_cd(pw[b], gt_r, rot, extra=[r_p])
            f_r = search.fscore(acc_d, comp_d, thresholds).cpu().numpy()
            fold(gaps, {"sample_gap": surface.far_share(pred_p, matched, SCORED_TOL),
                              "search_gap": max(0.0, cd_p - best) / best if math.isfinite(cd_p) else math.inf,
                              "gt_gap": float((gt_p - gt_r).norm() / gt_r.norm()),
                              "cd_gap": abs(cd_p - cd_r) / cd_r,
                              "fscore_gap": float(np.abs(np.asarray(kept["f"][b]) - f_r).max())})
        return gaps

    def control_outputs(self, ctl, kept, control):
        """The reference in the program's place through the whole protocol:
        its depth, intrinsics and dense grid under ``control``, the plain
        sampler on that grid, the reference's search, and the metrics of the
        clouds it picks."""
        out = super().control_outputs(ctl, kept, control)
        rot, pw = self.rotations(), out["world"]
        scored = {k: [] for k in ("pred_n", "gt_n", "acc", "comp", "f")}
        for b, row in enumerate(kept["idx"].tolist()):
            gt_r = self.gt_reference(row)
            _, best = search.least_cd(pw[b], gt_r, rot)
            pred = search.rotated(pw[b], rot[best: best + 1])[0]
            acc, comp, acc_d, comp_d = search.chamfer(pred, gt_r)
            for k, v in zip(scored, (pred, gt_r, float(acc), float(comp),
                                     search.fscore(acc_d, comp_d, self.opt.eval.f_thresholds).cpu().numpy())):
                scored[k].append(v)
        return dict(out, pred_n=torch.stack(scored["pred_n"]), gt_n=torch.stack(scored["gt_n"]),
                    acc=np.asarray(scored["acc"]), comp=np.asarray(scored["comp"]), f=np.stack(scored["f"]))

    def layer_context(self, summary, units):
        ctx = super().layer_context(summary, units)
        m = self.mix
        ctx["samples"] = self.B * units
        ctx["k2_comparisons"] = ctx["samples"] * work.chamfer_comparisons(math.prod(m["rot_samples"]),
                                                                           m["eval"]["num_points"], m["gt_points"])
        return ctx
