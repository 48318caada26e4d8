"""Typed configuration for the HiPR-FISH pipeline.

The reference scatters its constants across scripts (laser lists, patch=11,
nphi=9, size gates 600/100/60/50/10, shift clamp 15, n_neighbors=25,
SVC(C=10, gamma=0.5), excitation block boundaries); see e.g.
hiprfish-image-analysis-ecoli/hiprfish_imaging_spectral_image_measurement.py:44-127
and hiprfish-image-analysis-reference-training/hiprfish_imaging_train_reference.py:1401,1488.
Here everything lives in frozen dataclasses so pipelines are pure functions of
(config, data) and can be traced/jitted once per config.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChannelLayout:
    """Spectral channel layout for one experiment family.

    The reference supports two layouts (SURVEY.md §0):
      * 10-bit / 5-laser (405/488/514/561/633): 95 channels, per-laser block
        boundaries [0,32,55,75,89,95]
        (hiprfish_imaging_train_reference.py:1401).
      * 7-bit / 4-laser (488/514/561/633): 63 channels, blocks
        [0,23,43,57,63] (hiprfish_imaging_train_reference.py:1488).
    """

    name: str
    lasers: Tuple[str, ...]
    n_channels: int
    block_bounds: Tuple[int, ...]  # len == n_lasers + 1
    n_bits: int
    # OR-groups of barcode bit indices defining each per-laser "check bit"
    # (which fluorophores light up a given excitation block). 10-bit groups:
    # hiprfish_imaging_train_reference.py:1408-1412; 7-bit: :1778-1781.
    check_bit_groups: Tuple[Tuple[int, ...], ...]

    @property
    def n_lasers(self) -> int:
        return len(self.lasers)

    @property
    def n_barcodes(self) -> int:
        return 2**self.n_bits - 1

    @property
    def blocks(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (self.block_bounds[i], self.block_bounds[i + 1])
            for i in range(len(self.block_bounds) - 1)
        )

    def code_str(self, enc: int) -> str:
        """Zero-padded binary barcode string, e.g. 5 -> '0000000101'."""
        return format(enc, "0{}b".format(self.n_bits))


# Bits of the 10-bit code retained by the 7-bit subset
# (convert_code_to_7b, hiprfish_imaging_train_reference.py:24-27).
SEVEN_BIT_SUBSET = (0, 2, 3, 4, 7, 8, 9)


TEN_BIT = ChannelLayout(
    name="10bit",
    lasers=("405", "488", "514", "561", "633"),
    n_channels=95,
    block_bounds=(0, 32, 55, 75, 89, 95),
    n_bits=10,
    check_bit_groups=(
        (1, 5, 6),          # c1: 405 block
        (9, 2, 0),          # c2: 488 block
        (9, 0, 2, 8, 7),    # c3: 514 block
        (7, 8),             # c4: 561 block
        (3, 4),             # c5: 633 block
        (1,),               # c6: violet-derivative block (train_reference.py:1454)
    ),
)

SEVEN_BIT = ChannelLayout(
    name="7bit",
    lasers=("488", "514", "561", "633"),
    n_channels=63,
    block_bounds=(0, 23, 43, 57, 63),
    n_bits=7,
    check_bit_groups=(
        (6, 1, 0),          # c1: 488 block (train_reference.py:1778)
        (6, 0, 1, 4, 5),    # c2: 514 block
        (4, 5),             # c3: 561 block
        (2, 3),             # c4: 633 block
    ),
)


def convert_code_to_7b(code: str) -> str:
    """Project a 10-bit barcode string onto the 7-bit fluorophore subset."""
    return "".join(code[i] for i in SEVEN_BIT_SUBSET)


def convert_code_to_10b(code: str) -> str:
    """Embed a 7-bit barcode string into the 10-bit space (zeros on the
    unused bits — inverse of convert_code_to_7b; train_reference.py uses
    this to match taxon tables against 10-bit reference encodings)."""
    out = ["0"] * 10
    for bit, i in zip(code, SEVEN_BIT_SUBSET):
        out[i] = bit
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Parameters of the segmentation engines (L2).

    Defaults reproduce the reference's hardcoded constants; citations inline.
    """

    # Line-profile stencil (neighbor2d.pyx:8, neighbor.pyx:115)
    patch_size: int = 11
    phi_range: int = 9
    theta_range: int = 9  # 3D only; orientations = (theta_range-1)*phi_range

    # Registration
    max_shift: int = 15        # ecoli shift clamp (spectral_image_measurement.py:54-57)
    clamp_shift: bool = True
    # Fused-path FFT registration runs on a centered power-of-two crop
    # (same integer shift for rigid stage drift — it is clamped to +/-15 px
    # anyway — with ~16x cheaper FFTs at 2000^2; 0 disables and correlates
    # the full frame like the reference).
    register_crop: int = 512
    # Storage dtype of the registered multi-channel cube inside the FUSED
    # device engines (pipeline/fused.py, fused_ecoli.py). The cube is the
    # pipelines' largest buffer (1.5 GB at 2000^2 x 95 f32) and is consumed
    # only by per-cell spectral sums; bfloat16 halves its roll/concat/stats
    # memory traffic.
    # Quantization (~2^-9 relative per pixel) averages out over each cell's
    # ~200 px: barcode calls are identical on the 2000^2 bench fixtures and
    # the fused-vs-host equivalence tests assert call agreement. The
    # host-composed engines (segment2d, the CPU/parity path) always measure
    # in float32; set "float32" here to match them bit-for-bit.
    registered_dtype: str = "bfloat16"
    # KMeans/log-sum inputs always stay float32: the per-laser 2D channel
    # sums are computed from the raw planes BEFORE quantization.

    # NL-means denoising (multispecies_spectral_image_measurement.py:108)
    nlm_h: float = 0.02
    nlm_patch_size: int = 7
    nlm_patch_distance: int = 11

    # KMeans
    kmeans_iters: int = 40

    # ecoli erosion-seeded watershed (spectral_image_measurement.py:96-126)
    seed_area_max: int = 600        # regions smaller than this become seeds
    seed_min_size: int = 10         # remove_small_objects during erosion loop
    cell_min_size: int = 100        # remove_small_objects on watershed output
    minor_axis_min: float = 15.0
    minor_axis_max: float = 35.0
    max_erosion_iters: int = 40     # static bound for the data-dependent loop

    # LP-CV segmentation (multispecies_spectral_image_measurement.py:110-157)
    lp_seed_min_size: int = 10
    lp_cell_min_size: int = 60
    watershed_max_iters: int = 256  # static bound for flood propagation
    ccl_max_iters: int = 512        # static bound for label propagation
    # Doubling cap for the id floods' segmented scans: passes per fixpoint
    # round scale with log2(cap), and a cap below the largest component
    # extent only adds rounds, never changes the result (labeling.py).
    # ~the cell extent is the sweet spot (both caps are bit-exact on the
    # 2020x2020x170 flagship: 9408/9408 cells, accuracy 1.0).
    scan_cap: int = 16

    # biofilm epithelial-region detection (biofilm_analysis.py:404-418)
    bkg_min_size: int = 10000
    epithelial_disk_radius: int = 100

    # biofilm debris filter (biofilm_analysis.py:1263-1269)
    debris_area_max: int = 10000
    debris_prob_min: float = 0.95

    # 3D tiling (biofilm_analysis.py:900-917, 1105-1126)
    tile_xy: int = 256
    tile_halo: int = 10


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Parameters for spectral classifier training (L5) and inference (L4)."""

    n_neighbors: int = 25           # UMAP n_neighbors (train_reference.py:2037)
    simulations_per_code: int = 2000
    # Check-bit classifier head (replaces per-block svm.SVC(C=10, gamma=0.5))
    check_hidden: int = 64
    check_train_steps: int = 1000
    check_lr: float = 3e-3
    check_batch: int = 4096
    # KNN soft-vote temperature for barcode probabilities
    # Sharper voting approaches exact 1-NN: measured on the 1023-class
    # configuration, T=300 scores 0.9883 on clean spectra vs 0.9814 at the
    # old T=30 (exact 1-NN = 0.9902; the residual is genuine fluorophore
    # crosstalk between adjacent bits, which the reference shares).
    knn_temperature: float = 300.0
    # Spectra simulation (train_reference.py:1402-1404, 1899)
    excitation_adjust_low: float = 0.4
    excitation_adjust_high: float = 1.0
    fret_distance_low: float = 6.0
    fret_distance_high: float = 10.0
    dtype: str = "float32"
