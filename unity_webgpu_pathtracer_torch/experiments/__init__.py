"""H100 counterparts of the reference's Pallas measurement probes.

One module per original in ``experiments/``, under the same name.  Each
makes the original's inputs from the same seeds and sizes with numpy (its
own generator: the numbers are not JAX's), runs the probe's kernels
(``ops/cuda_probes.py``, and the K1 probe modes of
``ops/cuda_arrival.py``) on the card, holds each against its plain
version, and times it:

    python -m unity_webgpu_pathtracer_torch.experiments.<name>

``run(device=None)`` returns one dict per measurement; ``main()`` prints
the original's lines.  Both need a CUDA device and raise without one.
"""
