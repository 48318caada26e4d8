"""Small end-to-end 3D biofilm demo: synthetic volume -> margin-tiled
segmentation -> streamed 63-channel measurement -> barcode recovery.

This is the reference's 3D biofilm workflow
(hiprfish_imaging_biofilm_analysis.py:1105-1171 segmentation,
:1359-1417 measurement/classification) at toy scale, runnable on CPU in a
couple of minutes:

    JAX_PLATFORMS=cpu python examples/demo_3d_biofilm.py

On a GPU drop JAX_PLATFORMS; the same code path runs the full
2020x2020x170 reference scale via tools/bench3d.py.
"""

import numpy as np
import jax
import jax.numpy as jnp

from hiprfish_tpu.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu.pipeline import segment3d
from hiprfish_tpu.utils import synthetic, synthetic3d as s3


def main():
    layout = SEVEN_BIT
    spec = s3.VolumeSpec(shape=(300, 160, 48), spacing=(36, 36, 24),
                         semi_axes_lo=(10.0, 7.0, 7.0),
                         semi_axes_hi=(12.0, 8.0, 9.0), seed=3)
    lut = synthetic.fluorophore_spectra(layout)
    code_spectra = np.stack([synthetic.barcode_spectrum(layout, c, lut)
                             for c in range(1, 128)])
    node_code_idx = s3.node_codes(spec, 127)

    vol = s3.build_sum_volume(spec, 127,
                              jnp.asarray(code_spectra).sum(axis=1),
                              seed=1, z_chunk=16)
    print(f"volume {vol.shape}, {spec.n_cells} planted cells")

    cfg = SegmentationConfig()
    join = segment3d.warmup_pipeline((300, 160, 48), cfg, max_cells=512,
                                     tile_x=100, margin=40, tile_cap=256,
                                     z_chunk=8,
                                     n_channels=layout.n_channels)
    join()

    seg, n_found, _ = segment3d.segment_3d_tiled(
        vol, cfg, max_cells=512, tile_x=100, margin=40, tile_cap=256,
        chunk_xy=64)
    seg = np.asarray(seg)
    print(f"cells found: {int(n_found)} / {spec.n_cells}")

    lut_j = jnp.asarray(code_spectra)

    def loader(z0, zc):
        return s3.channel_chunk_cm(spec, 127, z0, zc, lut_j,
                                   jax.random.PRNGKey(1))

    avg = np.asarray(segment3d.measure_volume_streamed(
        jnp.asarray(seg), loader, 48, 8, layout.n_channels, 512,
        channels_major=True))

    truth = np.asarray(s3.truth_chunk(spec, 127, 0, 48)[0])
    gn = code_spectra / np.linalg.norm(code_spectra, axis=1, keepdims=True)
    ok = tot = 0
    for lab in range(1, int(n_found) + 1):
        tl = truth[seg == lab]
        tl = tl[tl > 0]
        if tl.size == 0:
            continue
        planted = int(node_code_idx[np.bincount(tl).argmax() - 1])
        v = avg[lab]
        v = v / max(np.linalg.norm(v), 1e-12)
        tot += 1
        ok += int((v @ gn.T).argmax()) == planted
    print(f"barcode recovery: {ok}/{tot}")


if __name__ == "__main__":
    main()
