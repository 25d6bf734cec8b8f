"""How far cuDNN's f32 convolutions move the conv triplets' gradients.

Computes ``muzero_loss``'s gradient for the ResNet triplet at its
defaults (64 channels, 4 blocks, Connect Four's planes, ``chip_smoke.py``
phase 26's batch) on the card, against a float64 gradient on the CPU,
under cuDNN's default algorithms, with torch's symmetric ``padding=`` in
place of the explicit SAME pad, and under the ``ieee`` fp32 precision
flags; then two controls of lower precision, which the limit of phase 26's
check must catch: TF32 on for the convolutions and the matmuls, and
``muzero_loss``'s bf16 compute (f32 master gradients). For one 64-channel
6 x 7 convolution it gives the card's output, input gradient and weight
gradient against float64, each relative to its largest entry. Prints one
JSON line per setting. Needs a CUDA card; run from the repository's
root:

  python3 tools/conv_precision.py
"""
import dataclasses
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())


def main():
  import chip_smoke as cs
  from muax_tpu_torch.models import make_resnet_networks, networks
  from muax_tpu_torch.models.losses import muzero_grad

  if not torch.cuda.is_available():
    sys.exit("conv_precision: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev, cpu = torch.device("cuda", 0), torch.device("cpu")
  print(cs.card_line(), "torch", torch.__version__, "cudnn",
        torch.backends.cudnn.version())

  def moved(batch, d, dtype=None):
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(
            d, dtype if dtype is not None
            and getattr(batch, f.name).is_floating_point() else None)
        for f in dataclasses.fields(batch)})

  frame, A = cs.RESNET_PLANES, 7
  batch = cs.seeded_conv_batch(A, 16, cs.TRAIN_UNROLL, frame, False,
                               cs.SEED + 1)
  net_cpu = make_resnet_networks(A, device=cpu, **cs.RESNET_NET)
  p64 = net_cpu.init_params(frame,
                            torch.Generator().manual_seed(cs.SEED)).double()
  g64, _ = muzero_grad(p64, moved(batch, cpu, torch.float64), net_cpu)

  def one_conv():
    """One 64-channel 6 x 7 conv on the card against float64, each error
    relative to the largest entry of its reference."""
    x = torch.randn(64, 64, 6, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    w = torch.randn(64, 64, 3, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4)) / 24
    x.requires_grad_()
    w.requires_grad_()
    y = F.conv2d(F.pad(x, (1, 1, 1, 1)), w)
    gy = torch.randn_like(y)
    gx, gw = torch.autograd.grad(y, (x, w), gy)
    xg = x.detach().float().to(dev).requires_grad_()
    wg = w.detach().float().to(dev).requires_grad_()
    yg = F.conv2d(F.pad(xg, (1, 1, 1, 1)), wg)
    gxg, gwg = torch.autograd.grad(yg, (xg, wg), gy.float().to(dev))
    return {name: float((got.detach().cpu().double() - ref.detach()).abs()
                        .max() / ref.detach().abs().max())
            for name, got, ref in (("y", yg, y), ("gx", gxg, gx),
                                   ("gw", gwg, gw))}

  def run(label, **loss_kwargs):
    net = make_resnet_networks(A, device=dev, **cs.RESNET_NET)
    params = net.init_params(frame, torch.Generator().manual_seed(cs.SEED))
    grads, _ = muzero_grad(params, moved(batch, dev), net, **loss_kwargs)
    err = (grads.cpu().double() - g64).abs()
    print(label, json.dumps({
        "grad_max_err": float(err.max()),
        "rel_to_max": float(err.max() / g64.abs().max()),
        "one_conv_rel_err": one_conv()}), flush=True)

  run("default")
  same_pad_forward = networks.SameConv2d.forward

  def symmetric(self, x):
    k = self.kernel_size[0]
    if self.stride[0] == 1 and k % 2 == 1:
      return F.conv2d(x, self.weight, self.bias, 1, k // 2)
    return same_pad_forward(self, x)

  networks.SameConv2d.forward = symmetric
  try:
    run("symmetric_padding")
  finally:
    networks.SameConv2d.forward = same_pad_forward
  torch.backends.cudnn.conv.fp32_precision = "ieee"
  run("cudnn_conv_fp32_precision_ieee")
  torch.backends.fp32_precision = "ieee"
  run("global_fp32_precision_ieee")
  run("bf16_compute_control", compute_dtype=torch.bfloat16)
  torch.backends.cudnn.conv.fp32_precision = "tf32"
  torch.backends.cuda.matmul.fp32_precision = "tf32"
  run("tf32_control")


if __name__ == "__main__":
  main()
