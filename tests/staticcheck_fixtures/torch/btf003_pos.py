"""BTF003 positive fixture (the port's rule): host syncs inside hot
functions.

Expected findings: 12 — inside tick(): int() over a device-carry name,
np.asarray on a non-literal, .item(), .tolist(), .cpu(), .numpy(),
.to("cpu"), .to(device=torch.device("cpu")), torch.cuda.synchronize();
an Event's .synchronize() inside mixed_block_async() (the port's fused
mixed block dispatch); a bool() over a *_dev carry inside _mixed_scan()
(the eager loop that stands in for the JAX package's lax.scan); a
ticklog record() that .tolist()s a device value into its entry.
"""
import numpy as np
import torch


class Sched:
    def tick(self):
        logits = self.engine.last_logits
        tok = int(logits[0])                          # 1: int over device name
        arr = np.asarray(self.engine.carry)           # 2: non-literal asarray
        val = self._probe_dev.item()                  # 3: .item()
        lst = self._next_dev.tolist()                 # 4: .tolist()
        host = logits.cpu()                           # 5: .cpu()
        view = self.engine.carry.numpy()              # 6: .numpy()
        back = logits.to("cpu")                       # 7: .to("cpu")
        back2 = logits.to(device=torch.device("cpu"))  # 8: .to(device=cpu)
        torch.cuda.synchronize()                      # 9: device-wide wait
        return tok, arr, val, lst, host, view, back, back2


class Engine:
    def mixed_block_async(self, slots: list):
        self._done.synchronize()                      # 10: Event wait
        return slots


def _mixed_scan(steps, live_dev):
    for _ in range(steps):
        if bool(live_dev.any()):                      # 11: bool over _dev
            break


class TickLog:
    def record(self, wall_s, phases):
        # a per-tick record must never fetch device state to enrich
        # the entry
        return {"wall": wall_s, "q": self.engine.queue_dev.tolist()}  # 12
