"""PyTorch/CUDA port of ``gnss_sim_receiver_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names
(``models.acquisition``, ``models.tracking``, ``ops.pcps`` ...) and runs the
GPS L1 C/A and Galileo E1-B chains, alone or together, and the GPS L5I and
Galileo E5a-I chains, from a conf file and a capture file through the
signal conditioner to a position, on one CUDA device (``python -m gnss_sim_receiver_tpu_torch --config_file=rx.conf``),
and synthesizes multi-satellite captures on the card
(``sim.device_generator``).
Its device kernels are written by hand (CUDA C++ under ``csrc/``, Triton in
``ops/pcps.py``, ``ops/filters.py`` and ``ops/resampler.py``) and each has a
plain PyTorch version beside it, which runs only on CPU tensors.  The
package imports torch, NumPy and SciPy, never JAX and nothing of
``gnss_sim_receiver_tpu``.
"""
