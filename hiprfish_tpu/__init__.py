"""hiprfish_tpu — HiPR-FISH spectral image analysis on an accelerator (JAX).

A from-scratch JAX/XLA/Pallas re-design of the HiPR-FISH image-analysis
pipeline (reference: proudquartz/hiprfish-image-analysis): registration,
edge-enhanced single-cell segmentation, per-cell spectral measurement,
1023-barcode spectral classification, classifier training via spectral
simulation, and experiment aggregation — all running on the device (an NVIDIA GPU) with the
host-side runtime (I/O, workflow driver, CLI) kept byte-compatible with
the reference's file formats.

Layer map (mirrors SURVEY.md §1):
  L0 ops/          fused XLA programs and a Pallas kernel (LP-CV stencil,
                   KMeans, morphology, CCL, watershed, regionprops, FFT
                   registration, NL-means)
  L1 io/           CZI/NPY ingestion, experiment tables, output writers
  L2 pipeline/     registration + segmentation engines (2D/3D)
  L3 pipeline/     per-cell spectral measurement
  L4 pipeline/     spectral classification
  L5 models/       simulators, metrics, classifier training, artifacts
  L6 pipeline/     collection + summarization
  L7 cli/ workflows/  CLI entry points + batched workflow driver
"""

__version__ = "0.1.0"

from hiprfish_tpu.config import (  # noqa: F401
    ChannelLayout,
    TEN_BIT,
    SEVEN_BIT,
    SegmentationConfig,
    ClassifierConfig,
)
