"""Batched reconstruction in a closed loop: ``recon.reconstruct_batch`` on
batches drawn from a pool of analytic views, back to back.

Set-up makes the weights from the seed on the device, calibrates the random
decoder on the reference (float32, TF32 off) as a trained field looks on the
coarse lattice, loads those weights into the port, renders the pool and
warms up the call. Each call of the window reconstructs one batch and ends
in a sync; the calls whose outputs are checked are drawn from the seed.

The check runs the reference once the window has closed, on every sample of
the kept calls: the depth map and the intrinsics the encoder predicted;
the decoder's logits at every grid point the call decoded (the coarse
lattice, and the fine lattice of each cell the call refined, which the
selection rule gives from the call's own coarse values); and the surface
samples, drawn again by the plain sampler from the call's own level grid
and generator state. A number that is not finite reads as an infinite gap.
"""

import time

import numpy as np
import torch

from zsbench import program, scenes, work
from zsbench.reference import recon as ref_recon
from zsbench.reference import surface
from zsbench.reference.init import build_reference
from zsbench.reference.precision import exact_fp32
from zsbench.runners import fold, sync

# the occupancies a float32 sigmoid saturates to, and the sharpened logits they bound
TOP = 1.0 - 1e-6  # at or above: the logit is at least LOGIT_TOP (the last resolved step)
LOGIT_TOP = 13.815510557964274  # logit(1 - 1e-6)
LOGIT_ZERO = -87.0  # an occupancy of 0 needs a logit below about -87.3 (float32's least normal)
SAMPLE_TOL = 1e-3  # a surface sample farther than this share of the grid's range from the reference's is wrong


class Runner:
    def __init__(self, cfg, mix, seed, device):
        self.opts, self.mix, self.seed, self.device = cfg["options"], mix, seed, device
        self.B = mix["batch"]

    # -- set-up -----------------------------------------------------------
    def setup(self):
        m, dev = self.mix, self.device
        self.pool = scenes.make_pool(self.seed, self.opts["H"], m["pool_objects"], m["views_per_object"], dev)
        state = self.calibrated_state()
        opt = program.options(self.opts)
        self.model = program.recon_model(program.build_graph(opt, state, dev), m["sharpen"], dev)
        del state
        n_rows = self.pool["rgb_input_map"].shape[0]
        self.order = scenes.draw_order(self.seed, n_rows, m["max_calls"], self.B)
        self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        rng = np.random.default_rng(self.seed)
        self.keep_at = {0} | set(rng.integers(1, m["check_within"], m["check_calls"] - 1).tolist())
        self.calls, self.kept = 0, {}
        for _ in range(m["warmup_calls"]):
            self.call(keep=False)
        sync(dev)
        self.calls, self.kept = 0, {}

    def reference(self):
        with exact_fp32():
            return build_reference(self.opts, self.seed, self.device)

    def calibrated_state(self):
        """The seed's weights with the decoder calibrated on the pool's first
        view by the reference (float32, TF32 off), as the program gets them."""
        m = self.mix
        ref = self.reference()
        with exact_fp32():
            self.calibration = ref_recon.calibrate(
                ref, self.pool["rgb_input_map"][:1], self.pool["mask_input_map"][:1], m["sharpen"], m["vox_res"],
                m["range"], m["factor"], m["margin"], m["active_target"], m["inside"])
        return {k: v.detach().clone() for k, v in ref.reference_state().items()}

    def calibrated_reference(self):
        """The reference again from the seed, with the set-up's calibration applied."""
        ref = self.reference()
        shift, gain, _ = self.calibration
        out = ref.impl_network.impl_mlp.layers[-1]
        with torch.no_grad():
            out.weight.mul_(gain)
            out.bias.sub_(shift).mul_(gain)
        return ref

    def batch(self, c):
        idx = torch.as_tensor(self.order[c % len(self.order)], device=self.device)
        return {k: self.pool[k][idx] for k in ("rgb_input_map", "mask_input_map")}, idx

    # -- the timed path -----------------------------------------------------
    def call(self, keep=True):
        m = self.mix
        batch, idx = self.batch(self.calls)
        state = self.generator.get_state()  # the surface draws' start, for the check
        out, level, world, _ = program.reconstruct_batch(
            self.model, batch, self.generator, m["vox_res"], m["capacity"], m["num_points"], tuple(m["range"]),
            m["hier"])
        self.last = {"idx": idx, "depth": out["depth_pred"], "intr": out["intr_pred"], "level": level,
                     "world": world, "generator": state}
        if keep and self.calls in self.keep_at:
            self.kept[self.calls] = self.last
        self.calls += 1

    def window(self, seconds):
        times = []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            self.call()
            sync(self.device)
            end = time.perf_counter()
            times.append(end - t)
            if end - t0 >= seconds:
                break
        self.kept[self.calls - 1] = self.last
        elapsed = end - t0
        p95 = float(np.quantile(np.asarray(times), 0.95))
        return {"recon_img_per_s": self.B * len(times) / elapsed, "recon_batch_p95_ms": 1e3 * p95}, len(times)

    def traced_units(self):
        """The traced window: ``trace_calls`` calls, every one of them checked."""
        self.keep_at = set(range(self.calls, self.calls + self.mix["trace_calls"]))
        for _ in range(self.mix["trace_calls"]):
            self.call()
        return self.mix["trace_calls"]

    def release(self):
        del self.model
        self.last = None

    # -- the check ----------------------------------------------------------
    def check(self, control=None, fault=None):
        """The compared numbers over the kept calls (worst sample), from the
        reference; ``control`` (a context, such as ``fp8_matmuls``) runs the
        reference under it in the program's place instead of reading the
        program's outputs; ``fault(kept)`` alters the outputs first."""
        ref = self.calibrated_reference()
        ctl = self.calibrated_reference() if control else None
        self.details = []
        worst = {}
        self.needed_points = {}
        with exact_fp32(), torch.no_grad():
            for c, kept in sorted(self.kept.items()):
                if ctl is not None:
                    kept = self.control_outputs(ctl, kept, control)
                if fault is not None:
                    kept = fault(kept)
                fold(worst, self.check_call(ref, kept))
        return worst

    def check_call(self, ref, kept):
        """The compared numbers of one call, worst sample: the relative gap of
        the depth map and of the intrinsics; the decoder's logits at every
        point the call decoded (:func:`logit_gap`); and the share of surface
        samples that the plain sampler does not draw again."""
        m, dev = self.mix, self.device
        rgb = self.pool["rgb_input_map"][kept["idx"]]
        mask = self.pool["mask_input_map"][kept["idx"]]
        depth_r, intr_r, latent = ref.encode_image(rgb, mask)
        kvs = ref.impl_network.encode(latent)
        depth_p, intr_p = kept["depth"][..., 0].float(), kept["intr"].float()
        f, vox, rng = m["factor"], m["vox_res"], m["range"]
        n = vox // f + 1
        coarse = ref_recon.lattice(vox, rng, f, dev)
        gaps, cells = {}, []
        for b in range(rgb.shape[0]):
            d_p, d_r = depth_p[b], depth_r[b]
            row = {"depth_gap": float((d_p - d_r).norm() / d_r.norm()),
                   "intr_gap": float((intr_p[b] - intr_r[b]).norm() / intr_r[b].norm())}
            level = kept["level"][b].float()
            kv = ref_recon.sample_kvs(kvs, b)
            s_coarse = m["sharpen"] * ref_recon.decode(ref, kv, coarse)
            if m["hier"]:
                # the call refined the cells that its own coarse values select
                occ_c = level[::f, ::f, ::f]
                ids, _ = ref_recon.select_cells(occ_c, m["margin"], m["capacity"])
                fine, flat = ref_recon.cell_points(ids, vox, rng, f)
                # the far boundary planes of the level grid hold the last cell's
                # near corner where not refined: compare the coarse values inside
                inner = (slice(0, n - 1),) * 3
                occ_p = torch.cat([occ_c[inner].flatten(), level.flatten()[flat]])
                s_r = torch.cat([s_coarse.reshape(n, n, n)[inner].flatten(),
                                 m["sharpen"] * ref_recon.decode(ref, kv, fine)])
            else:  # the dense grid: every point was decoded
                ids = coarse.new_zeros(0)
                occ_p = level.flatten()
                s_r = m["sharpen"] * ref_recon.decode(ref, kv, ref_recon.dense_grid(vox, rng, dev))
            scale = s_coarse.std()
            row["logit_gap"], resolved = logit_gap(occ_p, s_r, scale)
            n_active = ref_recon.select_cells(torch.sigmoid(s_coarse).reshape(n, n, n), m["margin"], 1)[1]
            self.needed_points[int(kept["idx"][b])] = (work.hier_points(n_active, vox, f, m["capacity"]) if m["hier"]
                                                       else (vox + 1) ** 3)
            cells.append(ids)
            fold(gaps, row)
            self.details.append(dict(row, row_index=int(kept["idx"][b]), resolved=resolved, of=int(occ_p.numel()),
                                     field_std=float(scale), cells=int(ids.numel()), active_ref=n_active,
                                     depth_ref_mean=float(d_r.mean())))
        fold(gaps, self.check_samples(kept, cells))
        return gaps

    def reference_samples(self, kept, cells):
        """The plain sampler's world points ``[B, P, 3]`` from the call's level
        grids, its cells (coarse to fine) or every cube (dense), and the
        generator state the call started from (one generator drawn through
        the batch's samples in order)."""
        m = self.mix
        gen = torch.Generator(device=self.device)
        gen.set_state(kept["generator"])
        levels = kept["level"].float()
        pts = [surface.sample_cells(levels[b], cells[b], gen, m["num_points"], m["factor"]) if m["hier"]
               else surface.sample_dense(levels[b], gen, m["num_points"]) for b in range(levels.shape[0])]
        return surface.to_world(torch.stack(pts), m["vox_res"], m["range"])

    def check_samples(self, kept, cells):
        """``sample_gap``: the largest share, over the call's samples, of
        surface points farther than ``SAMPLE_TOL`` of the grid's range from
        the point that the plain sampler draws at the same index."""
        m = self.mix
        ref = self.reference_samples(kept, cells)
        tol = SAMPLE_TOL * (m["range"][1] - m["range"][0])
        return {"sample_gap": max(surface.far_share(kept["world"][b], ref[b], tol) for b in range(ref.shape[0]))}

    def control_outputs(self, ctl, kept, control):
        """The reference under ``control`` in the program's place: its depth,
        intrinsics and level grid for the same images (the coarse pass, its
        own cell selection, the fine pass), and the plain sampler's points
        on that grid."""
        m = self.mix
        rgb = self.pool["rgb_input_map"][kept["idx"]]
        mask = self.pool["mask_input_map"][kept["idx"]]
        f, vox, rng = m["factor"], m["vox_res"], m["range"]
        S, n = vox + 1, vox // f + 1
        with control():
            depth, intr, latent = ctl.encode_image(rgb, mask)
            kvs = ctl.impl_network.encode(latent)
            levels, cells = [], []
            coarse = ref_recon.lattice(vox, rng, f, self.device)
            for b in range(rgb.shape[0]):
                kv = ref_recon.sample_kvs(kvs, b)
                if not m["hier"]:
                    grid = ref_recon.dense_grid(vox, rng, self.device)
                    levels.append(torch.sigmoid(m["sharpen"] * ref_recon.decode(ctl, kv, grid)).reshape(S, S, S))
                    cells.append(None)
                    continue
                occ_c = torch.sigmoid(m["sharpen"] * ref_recon.decode(ctl, kv, coarse)).reshape(n, n, n)
                idx = torch.clamp(torch.arange(S, device=self.device) // f, max=n - 2)
                level = occ_c[idx][:, idx][:, :, idx].flatten()
                ids, _ = ref_recon.select_cells(occ_c, m["margin"], m["capacity"])
                fine, flat = ref_recon.cell_points(ids, vox, rng, f)
                level[flat] = torch.sigmoid(m["sharpen"] * ref_recon.decode(ctl, kv, fine))
                levels.append(level.reshape(S, S, S))
                cells.append(ids)
        out = dict(kept, depth=depth.float()[..., None], intr=intr.float(), level=torch.stack(levels).float())
        out["world"] = self.reference_samples(out, cells)
        return out

    # -- work for the per-layer metrics ---------------------------------------
    def layer_context(self, summary, units):
        """Counts of the traced calls: images, the decoder points the inputs
        need, the model FLOPs the inputs need (counted on the reference)."""
        m = self.mix
        ref = self.reference()
        rgb = self.pool["rgb_input_map"][: self.B]
        mask = self.pool["mask_input_map"][: self.B]
        with exact_fp32():
            enc_flops, (_, _, latent) = work.no_grad_flops(ref.encode_image, rgb, mask)
            trunk_flops, _ = work.no_grad_flops(ref.impl_network.encode, latent)
        L = latent.shape[1]
        traced = [c for c in range(self.calls - units, self.calls)]
        points = [self.needed_points.get(int(i)) for c in traced for i in self.order[c % len(self.order)]]
        if any(p is None for p in points):
            points = None
        del ref
        per_img = (enc_flops + trunk_flops) / self.B
        return {"images": self.B * units, "calls": units, "needed_points": points, "latent_keys": L,
                "encoder_flops_per_image": per_img, "decoder_flops_per_point": work.config_decoder_flops(1, self.opts, L)}


def logit_gap(occ_p, s_r, scale):
    """The gap of the program's occupancies ``occ_p`` from the reference's
    sharpened logits ``s_r`` at the same points, over ``scale`` (the spread
    of the reference's field on the coarse lattice): the root mean square
    over the points whose occupancy float32 resolves (over 0 and under
    ``TOP``), where the gap is the difference of the logits, and over the
    saturated points that contradict the reference, where it is how far the
    reference's logit lies beyond the bound that saturation sets on the
    program's (at least ``LOGIT_TOP`` at ``TOP`` and above, at most
    ``LOGIT_ZERO`` at 0). Returns the gap and the number of resolved points;
    an occupancy that is not finite or lies outside [0, 1], or a grid with
    no resolved point, is an infinite gap."""
    if not bool(torch.isfinite(occ_p).all()) or bool(((occ_p < 0) | (occ_p > 1)).any()):
        return float("inf"), 0
    resolved = (occ_p > 0) & (occ_p < TOP)
    n = int(resolved.sum())
    if n == 0:
        return float("inf"), 0
    beyond = torch.where(occ_p >= TOP, (s_r - LOGIT_TOP).clamp(max=0.0), (s_r - LOGIT_ZERO).clamp(min=0.0))
    diff = torch.where(resolved, torch.logit(occ_p.double().clamp(1e-300, TOP)).float() - s_r, beyond)
    counted = resolved | (beyond != 0)
    return float(diff[counted].square().mean().sqrt() / scale), n
