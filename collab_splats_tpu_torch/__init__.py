"""PyTorch + CUDA port of ``collab_splats_tpu``: the RaDe-GS forward render
and training step.

The layout mirrors the JAX package (``core/``, ``ops/``, ``models/``,
``train/``, ``data/``) so every module has a counterpart of the same name.
The port imports ``torch`` and ``numpy`` only: nothing of JAX and nothing
of the JAX package.  The hand-written Hopper kernels live in ``csrc/`` and
are bound by ``ops/cuda/``; each has a plain PyTorch version beside it that
the wrappers use for tensors on the CPU only.

Precision: the JAX package pins ``Precision.HIGHEST`` on its geometry and
compositing contractions (core/projection.py, core/compositing.py) because
a reduced-precision product of world->camera positions or covariances
measurably degrades training.  On the GPU the analogue of that trap is TF32,
so it is switched off here, once, for every product the port runs.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The JAX trainer resumes bit for bit because its reductions are
# deterministic; the port's kernels use no float atomics, and cuDNN (the
# SSIM filters) is held to deterministic algorithms too.
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
