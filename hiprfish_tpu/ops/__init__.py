"""L0 kernel layer: device equivalents of the reference's native kernels.

Reference native components (SURVEY.md §2.1):
  * neighbor2d.pyx line_profile_2d_v2   -> line_profile.line_profile_2d /
                                           line_profile.lp_cv_enhance_2d (fused)
  * neighbor.pyx line_profile_v2 / _memory_efficient_v2 / _v3
                                        -> line_profile.line_profile_3d /
                                           line_profile.lp_cv_enhance_3d
  * sklearn KMeans                      -> kmeans.kmeans1d
  * skimage morphology                  -> morphology.*
  * skimage label / relabel / border    -> labeling.*
  * skimage watershed                   -> watershed.watershed
  * skimage regionprops                 -> regionprops.*
  * skimage register_translation        -> register.register_translation
  * skimage denoise_nl_means            -> denoise.denoise_nl_means
                                           (+ nlm_triton kernel on the GPU)
"""
