"""clipcap_tpu_torch: the PyTorch/CUDA port of clipcap_tpu for NVIDIA Hopper.

The captioning main path (pixels -> CLIP ViT -> prefix mapper -> GPT-2
KV-cached decode -> caption sampler), laid out like the JAX package:
core/, ops/ (with ops/kernels/ and csrc/ for the hand-written CUDA
kernels), models/, lm/, decode/, eval/, tokenizers/, data/, and
convert.py for loading the JAX package's parameters.

Parallelism runs on torch.distributed, one process per device (torchrun
on GPUs, spawned gloo processes on the CPU): core/mesh.py (the (data,
pipe, model) mesh and the collectives), parallel/sharding.py (replicated
and ZeRO layouts), parallel/dp.py (data-parallel decode and serving),
parallel/tp.py (tensor-parallel GPT-J), parallel/pp.py (the GPipe
pipeline), parallel/sp.py (ring-attention ViT), parallel/ep.py with
models/moe.py (the expert-parallel MoE mapper), and
tools/dryrun_multichip.py, which drives them all.

Entry points (CaptionerBundle, decode.generate, NoBeamCaptionSampler) run
on the card unless given device="cpu". A kernel wrapper launches its
kernel on CUDA tensors and takes its plain PyTorch version only for CPU
tensors; nothing falls back from the card to the CPU. Importing the
package imports neither JAX, nor triton, nor the JAX package, and builds
no kernel.
"""
