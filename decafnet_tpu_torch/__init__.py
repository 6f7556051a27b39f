"""decafnet_tpu_torch: the PyTorch/CUDA port of decafnet_tpu for NVIDIA
Hopper (H100).

The port serves the live grounder (``model.name: iter``) through
:class:`~decafnet_tpu_torch.serve.GroundingService` and its HTTP endpoint
(``python -m decafnet_tpu_torch.serve``), and evaluates it on a dataset
through :class:`~decafnet_tpu_torch.eval.Evaluator`
(``python -m decafnet_tpu_torch.eval``). Its three fused ops run as
hand-written CUDA kernels on the card (csrc/) and as plain PyTorch on the
CPU. The port computes in full f32: TF32 is switched off for matrix
products and for cuDNN convolutions (which default to TF32). In bf16 the
matrix products sum in f32, as the JAX package's bf16 dots do: cuBLAS's
reduced-precision (bf16) reductions are switched off too.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
