"""Output artifact writers, byte-compatible with the reference's formats.

File contract per FOV (SURVEY.md §5 checkpoint/resume): every stage persists
its results so later stages (and reruns) reload from disk:
  {sample}_avgint.csv        headerless CSV, np.savetxt style
                             (spectral_image_measurement.py:160)
  {sample}_avgint_norm.csv   ecoli: headerless; synthetic-community: pandas
                             header row 0..C-1 (multispecies...py:173)
  {sample}_seg.npy           int label image (save_segmentation)
  {sample}_seg.png           label2rgb render
  {sample}_cell_ids.txt      one barcode string per cell
                             (image_classification.py:63)
  {sample}_avgint_ids.csv    features + ids (image_classification.py:59-64)
  {sample}_cell_information.csv  7-bit cell table (classify_spectra.py:36-48)
  {sample}_*.bvox            Blender voxel export (biofilm_analysis.py:280-297)
"""

from __future__ import annotations

import colorsys
import struct
import zlib

import numpy as np


def save_avgint_csv(path: str, avgint: np.ndarray) -> None:
    """Headerless comma CSV, matching np.savetxt's %.18e default."""
    np.savetxt(path, np.asarray(avgint), delimiter=",")


def save_avgint_norm_csv_with_header(path: str, avgint_norm: np.ndarray) -> None:
    """Synthetic-community style: pandas default integer-column header."""
    import pandas as pd

    pd.DataFrame(np.asarray(avgint_norm)).to_csv(path, index=None)


def label2rgb(labels: np.ndarray, seed: int = 7) -> np.ndarray:
    """Deterministic distinct colors per label, background black.

    Same role as skimage color.label2rgb(bg_label=0, bg_color=(0,0,0)).
    """
    labels = np.asarray(labels)
    n = int(labels.max()) + 1
    rng = np.random.RandomState(seed)
    hues = rng.permutation(n) / max(n, 1)
    lut = np.array(
        [colorsys.hsv_to_rgb(h, 0.9, 1.0) for h in hues], dtype=np.float32
    )
    lut[0] = 0.0
    return lut[np.clip(labels, 0, n - 1)]


def save_segmentation(segmentation: np.ndarray, sample: str, png: bool = True,
                      pixel_um: float = 0.0675) -> None:
    """Persist {sample}_seg.npy (+ _seg.png render).

    The render carries a physical-units scale bar like the reference's
    save_segmentation (biofilm_analysis.py:245-246: ScaleBar(0.0675, 'um',
    frameon=False, color='white')); pass pixel_um from the CZI metadata
    (io.czi.pixel_size_um) when available, or None/0 to omit the bar.
    """
    seg = np.asarray(segmentation)
    np.save(sample + "_seg.npy", seg)
    if png:
        _save_image_png(label2rgb(seg), sample + "_seg.png",
                        pixel_um=pixel_um, framed=False)


def save_identification_png(image_rgb_or_labels: np.ndarray, sample: str,
                            pixel_um: float = 0.0675) -> None:
    """Identification render with the reference's framed scale bar
    (biofilm_analysis.py:260-261: ScaleBar(0.0675, 'um', frameon=True,
    color='white', box_color='black', box_alpha=0.65, location=4))."""
    img = np.asarray(image_rgb_or_labels)
    if img.ndim == 2:
        img = label2rgb(img.astype(np.int64))
    _save_image_png(img, sample + "_identification.png",
                    pixel_um=pixel_um, framed=True)


def _nice_bar_um(width_um: float) -> float:
    """Largest 1/2/5·10^k length at most ~28% of the field width —
    matplotlib_scalebar's auto length rule, so figures look like the
    reference's."""
    target = width_um * 0.28
    if target <= 0:
        return 1.0
    k = np.floor(np.log10(target))
    for m in (5.0, 2.0, 1.0):
        cand = m * 10.0 ** k
        if cand <= target:
            return float(cand)
    return float(10.0 ** (k - 1) * 5.0)


def _add_scalebar(ax, shape, pixel_um: float, framed: bool) -> None:
    """Draw a physical-units scale bar with matplotlib primitives
    (matplotlib_scalebar is not installable here; this reproduces its
    look: white bar + 'N µm' label, optionally on a black box, lower
    right)."""
    from matplotlib import patches

    h, w = shape[0], shape[1]
    bar_um = _nice_bar_um(w * pixel_um)
    bar_px = bar_um / pixel_um
    label = ("%g µm" % bar_um) if bar_um < 1000 else ("%g mm" % (bar_um / 1e3))
    pad_x, pad_y = 0.04 * w, 0.04 * h
    bar_h = max(h * 0.012, 1.0)
    x1 = w - pad_x
    x0 = x1 - bar_px
    y = h - pad_y
    if framed:
        box = patches.FancyBboxPatch(
            (x0 - 0.015 * w, y - 4.2 * bar_h - 0.035 * h),
            bar_px + 0.03 * w, 4.2 * bar_h + 0.05 * h,
            boxstyle="square,pad=0", facecolor="black", alpha=0.65,
            edgecolor="none", zorder=9)
        ax.add_patch(box)
    ax.add_patch(patches.Rectangle(
        (x0, y - bar_h), bar_px, bar_h, facecolor="white",
        edgecolor="none", zorder=10))
    ax.text((x0 + x1) / 2, y - 2.0 * bar_h, label, color="white",
            ha="center", va="bottom", zorder=10,
            fontsize=8, family="sans-serif")


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) RGB image in [0, 1] (or uint8) as an 8-bit PNG
    with numpy and zlib alone."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w = a.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          a.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _draw_scalebar_pixels(rgb: np.ndarray, pixel_um: float,
                          framed: bool) -> np.ndarray:
    """The scale bar of _add_scalebar drawn straight into the pixels (no
    text label), for writers without matplotlib."""
    out = np.array(rgb, np.float32, copy=True)
    h, w = out.shape[:2]
    bar_px = int(round(_nice_bar_um(w * pixel_um) / pixel_um))
    bar_h = max(int(round(h * 0.012)), 1)
    x1 = int(w - 0.04 * w)
    y1 = int(h - 0.04 * h)
    if framed:
        fy0 = max(y1 - 5 * bar_h - int(0.035 * h), 0)
        fx0 = max(x1 - bar_px - int(0.015 * w), 0)
        out[fy0:min(y1 + int(0.015 * h), h), fx0:min(x1 + int(0.015 * w), w)] \
            *= 0.35
    out[max(y1 - bar_h, 0):y1, max(x1 - bar_px, 0):x1] = 1.0
    return out


def _save_image_png(rgb: np.ndarray, path: str, pixel_um: float = None,
                    framed: bool = False) -> None:
    try:
        import matplotlib
    except ImportError:
        rgb = np.clip(rgb, 0, 1)
        if pixel_um:
            rgb = _draw_scalebar_pixels(rgb, float(pixel_um), framed)
        write_png(path, rgb)
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(frameon=False)
    fig.set_size_inches(5, 5)
    ax = plt.Axes(fig, [0, 0, 1, 1])
    fig.add_axes(ax)
    rgb = np.clip(rgb, 0, 1)
    ax.imshow(rgb)
    if pixel_um:
        _add_scalebar(ax, rgb.shape, float(pixel_um), framed)
    ax.set_axis_off()
    fig.savefig(path, dpi=300)
    plt.close(fig)


def save_sum_png(image: np.ndarray, sample: str, suffix: str = "_sum.png") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(frameon=False)
    fig.set_size_inches(5, 5)
    ax = plt.Axes(fig, [0, 0, 1, 1])
    fig.add_axes(ax)
    ax.imshow(np.asarray(image), cmap="jet")
    ax.set_axis_off()
    fig.savefig(sample + suffix, dpi=300)
    plt.close(fig)


def save_cell_ids(path: str, barcodes) -> None:
    """One barcode string per line (image_classification.py:63)."""
    with open(path, "w") as f:
        for b in barcodes:
            f.write(str(b) + "\n")


def save_bvox(volume: np.ndarray, path: str) -> None:
    """Blender voxel format: int32 LE header (nx,ny,nz,nframes) + F-order f32
    (biofilm_analysis.py:291-297)."""
    vol = np.asarray(volume)
    header = np.array([vol.shape[0], vol.shape[1], vol.shape[2], 1], dtype="<i4")
    with open(path, "wb") as f:
        header.tofile(f)
        vol.flatten("F").astype("<f4").tofile(f)


def save_identification_bvox(image_identification: np.ndarray, sample: str) -> None:
    """Per-channel RGB bvox export (biofilm_analysis.py:280-289)."""
    for i, c in enumerate("rgb"):
        save_bvox(
            image_identification[..., i],
            "{}_identification_{}.bvox".format(sample, c),
        )
