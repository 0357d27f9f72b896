#!/usr/bin/env python3
"""Does ``torch.profiler`` see every kernel of a prefill?

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 scripts/profiler_probe.py [--runs 60]

Builds the port's kernels, then profiles ``--runs`` bf16 full-width
qwen3-0.6b kernel-path prefills (``chip_smoke.py`` phase 6's batch) under
four settings, each after a device sync: device activity alone, host plus
device activity, and each of the two with ``--margin`` seconds of host
sleep inside the profiled window before the prefill and after its sync
(the last is what ``chip_smoke.py`` uses).  For each it prints the device
kernels the profiler saw per run, how many runs saw fewer than the most
any run saw, and how many saw fewer than ``n_layers`` flash-attention
kernels, beside the wrapper's own launch count.  A run that lost a flash
kernel prints its kernel sequence (``F`` for flash attention).  Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'src'))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=60)
    ap.add_argument('--margin', type=float, default=0.05)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profiler_probe: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import common as kc
    from repro_torch.models.api import build_model

    print(cs.card_identity(), torch.__version__, torch.version.cuda,
          flush=True)
    kc.kernel_library()
    model = build_model(get_config('qwen3-0.6b'))
    cfg = model.cfg
    b, s = cs.PREFILL_B, cs.PREFILL_S
    n_pages = 1 + b * s // cfg.page_size
    rng = np.random.default_rng(11)
    batch = {
        'tokens': torch.tensor(rng.integers(1, cfg.vocab_size, (b, s)),
                               device='cuda'),
        'page_table': torch.tensor((rng.permutation(n_pages - 1) + 1)
                                   .reshape(b, -1).astype(np.int32),
                                   device='cuda'),
    }
    params = model.init_params(0, device='cuda').to(torch.bfloat16)

    def prefill():
        cache = {k: v.to(torch.bfloat16) for k, v in model.init_cache(
            engine_pages=n_pages, device='cuda').items()}
        model.prefill_fn(params, cache, batch, use_kernel=True)

    prefill()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device, both = [ProfilerActivity.CUDA], [ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]
    results = []
    for name, activities, margin in (
            ('device only', device, 0.0),
            ('host + device', both, 0.0),
            (f'device only, {args.margin} s margins', device, args.margin),
            (f'host + device, {args.margin} s margins', both, args.margin)):
        seen, wrapper, lost = [], set(), 0
        for i in range(args.runs):
            kc.LAUNCHES['flash_attention'] = 0
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                time.sleep(margin)
                prefill()
                torch.cuda.synchronize()
                time.sleep(margin)
            counts = {e.key: e.count for e in prof.key_averages()
                      if e.device_type == cuda}
            flash = sum(c for k, c in counts.items() if 'flash' in k)
            seen.append(sum(counts.values()))
            wrapper.add(kc.LAUNCHES['flash_attention'])
            if flash != cfg.n_layers:
                lost += 1
                events = sorted((e for e in prof.events()
                                 if e.device_type == cuda),
                                key=lambda e: e.time_range.start)
                print(f'  {name} run {i}: {flash} flash kernels seen, '
                      f'{kc.LAUNCHES["flash_attention"]} launched; '
                      f'sequence ' + ''.join(
                          'F' if 'flash' in e.name else '.'
                          for e in events), flush=True)
        results.append((name, seen, lost, wrapper))
    most = max(max(seen) for _, seen, _, _ in results)
    for name, seen, lost, wrapper in results:
        print(f'{name}: kernels seen per run {sorted(set(seen))}; runs short '
              f'of {most} {sum(n < most for n in seen)}/{args.runs}; runs '
              f'missing a flash kernel {lost}/{args.runs}; wrapper launches '
              f'{sorted(wrapper)}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
