"""BTF003 negative fixture (the port's rule): the dispatch-ahead
discipline. Hot functions build operands from host lists and hand
device tensors on without reading them; the drain (not a hot function)
is where values come back to the host. A copy TO the card is no sync.
Expected findings: 0."""
import numpy as np
import torch


class Sched:
    def tick(self):
        slots = [0, 1, 2]
        ops = np.asarray([0, 1, 2], np.int32)         # literal host list
        dev = torch.as_tensor(ops).to("cuda:0")       # host -> device
        n = int(len(slots))                           # host int
        self._pending.append(self.engine.mixed_block_async(slots))
        return ops, dev, n

    def _assemble(self, rows: list, lens: list):
        return np.asarray(rows), np.array(lens)       # host containers

    def _drain_blocks(self):
        # the one blessed fetch: outside the hot set
        toks = self._pending.pop(0).cpu().numpy()
        torch.cuda.synchronize()
        return int(toks[0]), self.carry_dev.tolist()


class Engine:
    def mixed_block_async(self, slots: list):
        carry = self.carry_dev
        for _ in range(len(slots)):
            carry = carry + 1                         # stays on the card
        return carry.to(self.device, non_blocking=True)
