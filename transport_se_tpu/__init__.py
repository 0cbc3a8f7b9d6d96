"""transport_se_tpu: spectral-element tracer transport in JAX.

A from-scratch JAX/XLA implementation with the capabilities of the
E3SM transport_se mini-app (HOMME spectral-element tracer-advection path):
cubed-sphere GLL grid, RK-SSP3 horizontal advection of tracer mass with the
optimization-based monotone limiter, biharmonic hyperviscosity, and
vertically-Lagrangian transport with monotone PPM remap.
"""

__version__ = "0.1.0"
