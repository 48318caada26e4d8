"""E. coli reference/mix spectral image measurement CLI.

Flag-compatible with hiprfish_imaging_spectral_image_measurement.py:164-175:
  -i  per-laser image filenames (czi/npy/tif)
  -c  calibration toggle ('T'/'F')
  -cf calibration image filename (.npy)
Writes {sample}_avgint.csv, _avgint_norm.csv, _seg.npy, _seg.png.
"""

from __future__ import annotations

import argparse

import numpy as np
import jax.numpy as jnp

from hiprfish_tpu.config import SegmentationConfig, TEN_BIT
from hiprfish_tpu.io import images as iio
from hiprfish_tpu.io import tables
from hiprfish_tpu.pipeline import measure, segment2d


def measure_reference_images(image_names, cal_toggle="F",
                             calibration_filename="",
                             cfg=SegmentationConfig(), max_cells=4096):
    sample = tables.sample_from_image_name(image_names[0])
    print(f"Analyzing sample {sample}...")
    stack = iio.load_image_stack(image_names)
    from hiprfish_tpu.utils.platform import policy

    if policy().cli_engine == "fused":
        # Single-program engine (the one the bench times): one device
        # launch instead of hundreds.
        from hiprfish_tpu.pipeline import fused_ecoli

        seg, n_cells, registered, _ = fused_ecoli.segment_ecoli_device(
            tuple(jnp.asarray(a) for a in stack), cfg, max_cells)
        res = segment2d.Segmentation2D(
            seg, n_cells, registered,
            jnp.sum(registered.astype(jnp.float32), axis=2),
            jnp.zeros(seg.shape), jnp.zeros_like(seg),
            jnp.zeros(seg.shape, bool))
    else:
        res = segment2d.segment_ecoli(stack, cfg, max_cells)
    registered = res.registered
    if cal_toggle == "T" and not calibration_filename:
        # the reference defaults -c to 'T' and then crashes on the empty
        # default -cf (spectral_image_measurement.py:167-174 only works when
        # the Snakefile supplies both); degrade to uncalibrated instead
        print("calibration requested but no -cf file given; skipping")
        cal_toggle = "F"
    if cal_toggle == "T":
        cal = iio.load_calibration_image(calibration_filename)
        cal_cube = iio.build_calibration_cube(
            cal, registered.shape[2], TEN_BIT.block_bounds[1])
        registered = registered / jnp.asarray(cal_cube)
    n = int(res.n_cells)
    avgint, avgint_norm = measure.measure_fov(
        res.segmentation, registered, n, max_cells)
    measure.save_measurement(sample, avgint, avgint_norm,
                             np.asarray(res.segmentation))
    return res.segmentation, avgint


def main(argv=None):
    from hiprfish_tpu.utils.platform import apply_platform_env

    apply_platform_env()
    parser = argparse.ArgumentParser(
        "Measure HiPR-FISH reference spectral images")
    parser.add_argument("-i", "--image_name", dest="image_name", nargs="*",
                        default=[], type=str, help="Image filenames")
    parser.add_argument("-c", "--calibration", dest="cal_toggle", type=str,
                        default="T", help="Flat-field calibration toggle")
    parser.add_argument("-cf", "--calibration_images_filename",
                        dest="calibration_images_filename", type=str,
                        default="", help="Calibration image filename")
    parser.add_argument("--max_cells", type=int, default=4096)
    args = parser.parse_args(argv)
    measure_reference_images(
        args.image_name, args.cal_toggle, args.calibration_images_filename,
        max_cells=args.max_cells)


if __name__ == "__main__":
    main()
