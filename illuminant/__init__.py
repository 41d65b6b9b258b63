"""illuminant: a realtime 2D lighting + particle framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of sq/Illuminant
(the C# reference engine): SDF-based 2.5D lighting with cone-traced soft
shadows, a G-buffer scene representation, HDR resolve with on-device
luminance histograms, and a fused HBM-resident particle engine with SDF
collision — all expressed as pure functions over pytree state, jit-compiled
into single frame/step programs, sharding over device meshes via
jax.sharding.
"""

__version__ = "0.1.0"
