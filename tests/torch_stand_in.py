"""A stand-in engine shared by the port's tests: its PBS returns its
input, so a program runs its rounds on shapes alone — the linear
dataflow, the rounds and their rows — with no bootstrap.  It serves
both packages (it only reads `cts.shape`)."""


class StandInEngine:
    """`rows` logs each `lut_batch` call's rows.  With a `scheduler` it
    stands in for a fused scheduler's engine proxy, which is how
    `IrInterpreter` finds the scheduler to fan a radix node out on."""

    def __init__(self, device=None, scheduler=None):
        self.device = device
        self.rows: list = []
        if scheduler is not None:
            self._scheduler = scheduler

    def lut_batch(self, cts, polys):
        self.rows.append(int(cts.shape[0]))
        return cts
