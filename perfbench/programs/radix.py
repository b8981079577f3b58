"""Shared by the radix programs: the digit layout and the program's
tracing front door."""


def trace(config, fn):
    """The program's compiled graph of `fn` over two radix integers,
    traced through the port's front door as a client's SDK would."""
    from repro_torch.api.session import trace_program
    from repro_torch.api.tracing import IntSpec
    spec = IntSpec(config["integer"]["bits"], config["integer"]["msg_bits"])
    return trace_program(fn, (spec, spec))


def uniform(rng, config, n: int) -> list:
    return [rng.randrange(1 << config["integer"]["bits"]) for _ in range(n)]


def digits(value: int, config) -> list:
    """Little-endian digits of value mod 2^bits."""
    bits, m = config["integer"]["bits"], config["integer"]["msg_bits"]
    v = value % (1 << bits)
    return [(v >> (i * m)) & ((1 << m) - 1) for i in range(bits // m)]
