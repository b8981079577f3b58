"""radix_add: the sum of two encrypted radix integers, mod 2^bits.

The client encrypts each integer as its little-endian digits of
`msg_bits` bits (TFHE-rs's FheUint8 is four 2-bit message blocks); the
server runs the program's carry rounds; the client decrypts the digits
of the sum.
"""
from perfbench.programs import radix

PBS = 20    # logical PBS a request needs, frozen from the plan this benchmark was defined on


def build(config):
    return radix.trace(config, lambda a, b: a + b)


def sample(rng, config) -> list:
    return radix.uniform(rng, config, 2)


def input_messages(values, config) -> list:
    return [radix.digits(v, config) for v in values]


def expected_messages(values, config) -> list:
    a, b = values
    return [radix.digits(a + b, config)]
