"""Visual dumps (counterpart of ``zeroshape_tpu/vis.py``): images, depths,
meshes and point clouds (PLY), attention GIFs, turntable GIFs, the textured
seen-surface OBJ and the self-contained HTML gallery.

The JAX module writes through PIL, matplotlib and cv2; none of them is
imported here. PNGs go through ``data.common.write_png``, GIFs through the
port's encoder (:mod:`zeroshape_tpu_torch.gif`), and the colour tables are
the constants of :mod:`ops.colormaps`. Turntables render on a device
(:mod:`ops.render`); a renderer or encoder failure raises, with no other
renderer behind it. Arrays are NHWC numpy (or tensors, brought to the host).
"""

from __future__ import annotations

import base64
import os
import zlib

import numpy as np
import torch

from zeroshape_tpu_torch import gif
from zeroshape_tpu_torch.data.common import write_png
from zeroshape_tpu_torch.ops import colormaps
from zeroshape_tpu_torch.ops.marching_cubes import write_ply_mesh  # noqa: F401 (the one PLY mesh writer)

SEEN_SURFACE_MTL = (
    "newmtl material_0\nKa 0.200000 0.200000 0.200000\n"
    "Kd 0.752941 0.752941 0.752941\nKs 1.000000 1.000000 1.000000\n"
    "Tr 1.000000\nillum 2\nNs 0.000000\n"
)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _ensure_dir(path):
    os.makedirs(path, exist_ok=True)
    return path


def _names(idx):
    """The samples' names in the file names: dataset indices or strings."""
    return _np(idx).tolist()


def _to_uint8(img):
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Images / depths
# ---------------------------------------------------------------------------

def dump_images(output_path, idx, name, images, from_range=(0, 1), folder="dump"):
    """images ``[B, H, W, C]`` -> ``{output_path}/{folder}/{i}_{name}.png`` (RGB)."""
    lo, hi = from_range
    images = (_np(images).astype(np.float32) - lo) / (hi - lo)
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for i, img in zip(_names(idx), images):
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        write_png(os.path.join(out_dir, f"{i}_{name}.png"), _to_uint8(img))


def viridis_rgba(depth):
    """What ``plt.imsave(..., cmap="viridis")`` stores for a 2-D float32 map:
    min-max normalised over the map in float32 (all zeros for a constant
    map), looked up in the viridis table, opaque RGBA uint8."""
    d = np.asarray(depth, np.float32)
    vmin, vmax = d.min(), d.max()
    x = np.zeros_like(d) if vmin == vmax else (d - vmin) / (vmax - vmin)
    rgba = np.full(d.shape + (4,), 255, np.uint8)
    rgba[..., :3] = colormaps.lookup(colormaps.VIRIDIS, x)
    return rgba


def dump_depths(output_path, idx, name, depths, masks=None, rescale=False, folder="dump"):
    """Viridis depth dumps (RGBA PNG); with ``rescale`` the background is
    filled with the largest foreground depth first (util_vis.py:73-79)."""
    depths = _np(depths).astype(np.float32)
    if rescale and masks is not None:
        m = (_np(masks) > 0.5).astype(np.float32)
        fg_max = (depths * m).reshape(depths.shape[0], -1).max(axis=1)
        depths = depths * m + (1 - m) * fg_max.reshape(-1, *([1] * (depths.ndim - 1)))
    depths = 1.0 - depths
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for i, depth in zip(_names(idx), depths):
        write_png(os.path.join(out_dir, f"{i}_{name}.png"), viridis_rgba(depth.squeeze()))


def tb_image(tb, step, split, name, images, from_range=(0, 1), num_images=(4, 8)):
    """An image grid on TensorBoard (``tb.add_image``; util_vis.py:20-39): the
    first ``num_H * num_W`` images, row-major with ``num_W`` columns; nothing
    for a writer without ``add_image`` (or none)."""
    if not hasattr(tb, "add_image"):
        return
    num_H, num_W = num_images
    lo, hi = from_range
    images = _np(images).astype(np.float32)[: num_H * num_W]
    images = np.clip((images - lo) / (hi - lo), 0, 1)
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    B, H, W, C = images.shape
    cols = min(num_W, B)
    rows = -(-B // cols)
    grid = np.zeros((rows, cols, H, W, C), np.float32)
    grid.reshape(rows * cols, H, W, C)[:B] = images
    tb.add_image(f"{split}/{name}", grid.transpose(0, 2, 1, 3, 4).reshape(rows * H, cols * W, C), step,
                 dataformats="HWC")


# ---------------------------------------------------------------------------
# PLY / OBJ writers
# ---------------------------------------------------------------------------

def write_ply_points(fname, points, colors=None):
    points = np.asarray(points, np.float32)
    with open(fname, "wb") as f:
        props = "property float x\nproperty float y\nproperty float z\n"
        if colors is not None:
            props += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f.write(f"ply\nformat binary_little_endian 1.0\nelement vertex {len(points)}\n{props}end_header\n".encode())
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            rec = np.empty(len(points), dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
            rec["xyz"] = points
            rec["rgb"] = np.asarray(colors, np.uint8)
            f.write(rec.tobytes())


def dump_meshes(output_path, idx, name, meshes, folder="dump"):
    """meshes: a list of ``(vertices, faces)``; an empty mesh is skipped."""
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for i, (verts, faces) in zip(_names(idx), meshes):
        if len(verts) == 0:
            print("Mesh is empty!")
            continue
        write_ply_mesh(os.path.join(out_dir, f"{i}_{name}.ply"), verts, faces)


def dump_pointclouds(output_path, idx, name, pcs, colors=None, folder="dump"):
    """Point clouds as PLY; one-channel ``colors`` in [0, 1] go through jet."""
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for k, i in enumerate(_names(idx)):
        col = None
        if colors is not None:
            col = _np(colors[k])
            if col.shape[-1] == 1:
                col = colormaps.lookup(colormaps.JET, col[:, 0])
        write_ply_points(os.path.join(out_dir, f"{i}_{name}.ply"), _np(pcs[k]), col)


def dump_pointclouds_compare(output_path, idx, name, preds, gts, folder="dump"):
    """Red = prediction, green = GT, one fused PLY (util_vis.py:172-185)."""
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for k, i in enumerate(_names(idx)):
        pred, gt = _np(preds[k]), _np(gts[k])
        colors = np.zeros((len(pred) + len(gt), 3), np.uint8)
        colors[: len(pred), 0] = 255
        colors[len(pred):, 1] = 255
        write_ply_points(os.path.join(out_dir, f"{i}_{name}.ply"), np.vstack([pred, gt]), colors)


def dump_seen_surface(output_path, idx, obj_name, img_name, seen_projs, folder="dump", connect_thres=0.005):
    """Textured seen-surface OBJ + MTL (util_vis.py:129-170): a vertex for each
    pixel with z > 0, two triangles a pixel quad where their corners are
    valid and within ``connect_thres`` of the first corner. The text is the
    JAX writer's, byte for byte, formatted from numpy arrays at once."""
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for k, i in enumerate(_names(idx)):
        XYZ = _np(seen_projs[k]).astype(np.float32)  # [H, W, 3]
        H, W = XYZ.shape[:2]
        img_fname = f"{i}_{img_name}.png"
        with open(os.path.join(out_dir, f"{i}_{obj_name}.mtl"), "w") as f:
            f.write(SEEN_SURFACE_MTL + f"map_Ka {img_fname}\nmap_Kd {img_fname}\n")
        valid = XYZ[..., 2] > 0
        idx_map = np.zeros((H, W), np.int64)
        idx_map[valid] = np.arange(1, valid.sum() + 1)
        ys, xs = np.nonzero(valid)
        verts = np.empty((len(ys), 5), np.float64)
        verts[:, :3] = XYZ[ys, xs]
        verts[:, 3] = xs / W
        verts[:, 4] = 1.0 - ys / H

        def close(a, b):  # |a - b| < thres in float32, as np.linalg.norm of the float32 difference
            d = a - b
            return np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]) < connect_thres

        p00, p01, p10, p11 = XYZ[:-1, :-1], XYZ[:-1, 1:], XYZ[1:, :-1], XYZ[1:, 1:]
        v00, v01, v10, v11 = valid[:-1, :-1], valid[:-1, 1:], valid[1:, :-1], valid[1:, 1:]
        upper = v00 & v01 & v10 & close(p00, p01) & close(p00, p10)
        lower = v01 & v11 & v10 & close(p01, p11) & close(p01, p10)
        i00, i01, i10, i11 = idx_map[:-1, :-1], idx_map[:-1, 1:], idx_map[1:, :-1], idx_map[1:, 1:]
        tris = np.stack([np.stack([i00, i01, i10], -1), np.stack([i01, i11, i10], -1)], axis=2)  # [H-1, W-1, 2, 3]
        faces = tris[np.stack([upper, lower], axis=-1)]  # row-major, the upper triangle of a quad first
        with open(os.path.join(out_dir, f"{i}_{obj_name}.obj"), "w") as f:
            f.write(f"mtllib {i}_{obj_name}.mtl\n")
            f.write(("v %.4f %.4f %.4f\nvt %.8f %.8f\n" * len(verts)) % tuple(verts.ravel().tolist()))
            f.write("usemtl material_0\n")
            f.write(("f %d/%d %d/%d %d/%d\n" * len(faces)) % tuple(np.repeat(faces, 2, axis=1).ravel().tolist()))


# ---------------------------------------------------------------------------
# Attention overlays and GIFs
# ---------------------------------------------------------------------------

def show_att_on_image(img, att):
    """Overlay a ``[H, W]`` attention map in [0, 1] on an RGB ``[H, W, 3]``
    image through cv2's jet, normalised by its maximum (vis.py:226-234)."""
    heatmap = colormaps.CV2_JET[np.uint8(255 * np.asarray(att))].astype(np.float32) / 255
    cam = heatmap + np.float32(img)
    return cam / cam.max()


def dump_gif(fname, frames_uint8, duration=50):
    gif.write(fname, [np.asarray(f, np.uint8)[..., :3] for f in frames_uint8], duration=duration)


def dump_attentions(output_path, idx, name, attn_frames, folder="dump"):
    """attn_frames: a list (a sample) of lists of ``[H, W, 3]`` float frames."""
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for k, i in enumerate(_names(idx)):
        dump_gif(os.path.join(out_dir, f"{i}_{name}.gif"), [_to_uint8(f) for f in attn_frames[k]], duration=50)


def sample_seed(i):
    """The turntable's surface-draw seed of sample ``i``: the index itself,
    or the CRC-32 of a name (the demo names its samples)."""
    return int(i) if isinstance(i, (int, np.integer)) or str(i).isdigit() else zlib.crc32(str(i).encode())


def dump_meshes_viz(output_path, idx, name, meshes, folder="dump", n_views=15, image_size=320, device=None):
    """A turntable GIF a mesh (util_vis.py:348-405): the mesh centred and
    scaled to max-abs 1, rendered by :func:`ops.render.render_turntable` on
    ``device`` (None -> cuda) with all views in one pass, its surface draws
    seeded by :func:`sample_seed`, 100 ms a frame."""
    from zeroshape_tpu_torch import resolve_device
    from zeroshape_tpu_torch.ops.render import mesh_triangles, render_turntable

    dev = resolve_device(device)
    out_dir = _ensure_dir(os.path.join(output_path, folder))
    for k, i in enumerate(_names(idx)):
        verts, faces = meshes[k]
        if len(verts) == 0:
            continue
        v = np.asarray(verts, np.float32)
        v = v - v.mean(0)
        v = v / (np.abs(v).max() + 1e-8)
        generator = torch.Generator(device=dev).manual_seed(sample_seed(i))
        frames = render_turntable(mesh_triangles(v, faces), generator, n_views=n_views, image_size=image_size,
                                  device=dev)
        dump_gif(os.path.join(out_dir, f"{i}_{name}.gif"), frames.cpu().numpy(), duration=100)


# ---------------------------------------------------------------------------
# HTML gallery (util_vis.py:449-511): self-contained base64 report
# ---------------------------------------------------------------------------

def create_gif_html(dump_dir, html_path, skip_every=1):
    """Every ``skip_every``-th sample's PNGs and GIFs of ``dump_dir`` inlined as
    base64 into one table (vis.py:326-355, the same bytes)."""
    if not os.path.isdir(dump_dir):
        return
    by_sample = {}
    for f in sorted(os.listdir(dump_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in (".png", ".gif"):
            continue
        by_sample.setdefault(stem.split("_")[0], []).append(f)
    samples = sorted(by_sample, key=lambda s: int(s) if s.isdigit() else 0)[::skip_every]
    rows = []
    for s in samples:
        cells = []
        for f in by_sample[s]:
            with open(os.path.join(dump_dir, f), "rb") as fh:
                data = base64.b64encode(fh.read()).decode()
            mime = "image/gif" if f.endswith(".gif") else "image/png"
            cells.append(f'<td><img src="data:{mime};base64,{data}" width="224"/><br/>{f}</td>')
        rows.append(f"<tr><th>{s}</th>{''.join(cells)}</tr>")
    html = (
        "<html><head><style>table{border-collapse:collapse}td,th{border:1px solid #999;"
        "padding:4px;font-family:monospace}</style></head><body><table>"
        + "".join(rows)
        + "</table></body></html>"
    )
    with open(html_path, "w") as f:
        f.write(html)
