"""PyTorch/CUDA port of stlpose_tpu for NVIDIA Hopper (H100, sm_90a).

The JAX package ``stlpose_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. Ported so far: the
fused two-stage serving path (``engines.vase_evaluator.
build_fused_two_stage``: Faster R-CNN ResNet50-FPN -> score filter ->
cross-batch crop compaction -> affine crops -> HRNet-W32 -> heatmap
decode) in f32 and in the quantized bf16 flavor, pose training
(``engines.trainer.PoseTrainer`` around ``parallel.steps.
make_train_step``, f32 or bf16 on f32 weights), flip-TTA COCO evaluation
(``engines.evaluator.PoseEvaluator``), the qualitative vase evaluation
(``engines.vase_evaluator.VaseEvaluator``), style transfer
(``models.vgg``, ``models.adain``: the perceptual loss and the AdaIN
stylizer, inline in the host-warp pose pipeline and the detection
pipeline), detector training (``engines.detector_trainer``), the
EfficientDet detector family (``models.efficientdet``, in serving, the
vase engine and detector training), pose retrieval (``engines.retrieval_db.ArchDataExtractor``, decoding on K1,
and the host-side ``retrieval`` package with its HNSW index, built from
``native/hnsw.cpp`` with g++ at first use) and the CLI scripts 01-07 and
``aux_*`` that drive them (``scripts/``). The TPU kernels of these paths
are CUDA C++ kernels under ``kernels/csrc`` (built with nvcc at first
use).

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; with "cuda" and no GPU it raises. On CPU tensors
each kernel wrapper runs its plain PyTorch version; a CUDA tensor always
reaches the kernel.
"""

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument; raises
    when CUDA is asked for and no GPU is present (no silent CPU run)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device
