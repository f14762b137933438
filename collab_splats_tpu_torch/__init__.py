"""PyTorch + CUDA port of ``collab_splats_tpu``: the RaDe-GS forward render.

The layout mirrors the JAX package (``core/``, ``ops/``, ``models/``,
``data/``) so every module has a counterpart of the same name.  The port
imports ``torch`` and ``numpy`` only: nothing of JAX and nothing of the JAX
package.  The two hand-written Hopper kernels live in ``csrc/`` and are
bound by ``ops/cuda/``; each has a plain PyTorch version beside it that the
wrappers use for tensors on the CPU only.

Precision: the JAX package pins ``Precision.HIGHEST`` on its geometry and
compositing contractions (core/projection.py, core/compositing.py) because
a reduced-precision product of world->camera positions or covariances
measurably degrades training.  On the GPU the analogue of that trap is TF32,
so it is switched off here, once, for every product the port runs.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
