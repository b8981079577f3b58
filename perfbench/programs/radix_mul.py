"""radix_mul: the product of two encrypted radix integers, mod 2^bits
(partial products as bivariate lookups, then carry rounds)."""
from perfbench.programs import radix

PBS = 32    # logical PBS a request needs, frozen from the plan this benchmark was defined on


def build(config):
    return radix.trace(config, lambda a, b: a * b)


def sample(rng, config) -> list:
    return radix.uniform(rng, config, 2)


def input_messages(values, config) -> list:
    return [radix.digits(v, config) for v in values]


def expected_messages(values, config) -> list:
    a, b = values
    return [radix.digits(a * b, config)]
