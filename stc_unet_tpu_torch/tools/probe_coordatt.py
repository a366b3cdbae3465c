"""CoordAtt strip-pool probe on the card: kernel P against K1.

Counterpart of the pool part of ``tools/probe_coordatt.py``. At the
probe's four slide-tile decoder stages (B=14 tiles, hw x hw x C =
32² x 1024, 64² x 512, 128² x 256, 256² x 128, bf16 x) it times

- P ``dual_pools`` (``csrc/dual_pools.cu``): the TPU probe's single-pass
  design, a block per (image, 32 channels) walking H in order with the
  column sums carried in shared memory;
- K1 ``strip_pools`` (``csrc/coordatt_fused.cu``): the model's kernel,
  bands of rows in parallel and an ordered second pass;
- the two f32 ``torch.sum`` calls (P's plain version, the yardstick),

each with CUDA events (median of 10 calls after 2), beside the bound: x
read once and the two f32 outputs written, over 3.35 TB/s. Each is timed
twice (``tools/timing.py``): ``*_ms`` with the host's time to queue the
call, ``*_device_ms`` with the host's work hidden. P is held to
its plain version at each stage (rtol 1e-5, atol 1e-4, as K1; two runs
bit-identical). It prints one JSON line and writes no file. It needs a
CUDA card::

    python -m stc_unet_tpu_torch.tools.probe_coordatt [--batch 14]
"""
from __future__ import annotations

import argparse
import json
import sys

STAGES = [(32, 1024), (64, 512), (128, 256), (256, 128)]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory


def check_dual_pools(x):
    """P on x (a CUDA tensor) against its plain version (rtol 1e-5, atol
    1e-4) and its own rerun (bit-identical); the max abs error."""
    import torch

    from stc_unet_tpu_torch.ops import dual_pools as dp
    sh, sw = dp.dual_pools(x)
    sh2, sw2 = dp.dual_pools(x)
    eh, ew = dp.dual_pools_reference(x)
    torch.testing.assert_close(sh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sw, ew, rtol=1e-5, atol=1e-4)
    if not (torch.equal(sh, sh2) and torch.equal(sw, sw2)):
        raise AssertionError(f'dual_pools not deterministic {x.shape}')
    return max((sh - eh).abs().max().item(), (sw - ew).abs().max().item())


def probe(batch: int = 14, seed: int = 0, check: bool = True) -> dict:
    """Time P, K1 and the two sums at the four stages, and with ``check``
    hold P to its plain version there first; the record, with each stage's
    times (and P's max abs error)."""
    import torch

    from stc_unet_tpu_torch.ops import coordatt_fused as cf
    from stc_unet_tpu_torch.ops import dual_pools as dp
    from stc_unet_tpu_torch.tools.timing import device_ms, event_ms
    if not torch.cuda.is_available():
        raise RuntimeError('probe_coordatt needs a CUDA card')
    g = torch.Generator(device='cuda').manual_seed(seed)
    stages, err = [], 0.0
    for hw, c in STAGES:
        x = torch.rand((batch, hw, hw, c), generator=g,
                       device='cuda').to(torch.bfloat16)
        e = check_dual_pools(x) if check else None
        err = max(err, e or 0.0)
        out_bytes = (batch * hw * c * 2) * 4
        calls = dict(dual_pools=lambda: dp.dual_pools(x),
                     strip_pools=lambda: cf.strip_pools(x),
                     torch_sums=lambda: dp.dual_pools_reference(x))
        stages.append(dict(
            hw=hw, c=c, batch=batch,
            **{f'{name}_ms': event_ms(fn) for name, fn in calls.items()},
            **{f'{name}_device_ms': device_ms(fn)
               for name, fn in calls.items()},
            bound_ms=(x.numel() * 2 + out_bytes) / HBM_BYTES_PER_S * 1e3,
            bytes=x.numel() * 2 + out_bytes, flops=2 * x.numel(),
            **({} if e is None else dict(dual_pools_max_abs_err=e))))
        del x
        torch.cuda.empty_cache()
    total = {k: sum(s[k] for s in stages) for k in
             ('dual_pools_ms', 'strip_pools_ms', 'torch_sums_ms',
              'dual_pools_device_ms', 'strip_pools_device_ms',
              'torch_sums_device_ms', 'bound_ms')}
    return dict(probe='coordatt strip pools', dtype='bfloat16',
                device=torch.cuda.get_device_name(0),
                timer='CUDA events, median of 10 after 2; *_device_ms with '
                      'the host hidden behind a sleep kernel',
                stages=stages, total=total, **({} if not check else dict(
                    dual_pools_max_abs_err=err,
                    tolerance='rtol 1e-5 atol 1e-4 against two f32 '
                              'torch.sum; reruns bit-identical')))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=14)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('probe_coordatt: CUDA is not available', file=sys.stderr)
        return 1
    print(json.dumps(probe(args.batch)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
