"""Exception types of the PyTorch port (its own copies: the port imports
nothing of the JAX package)."""


class LoroError(Exception):
    pass


class DecodeError(LoroError):
    pass


class CodecDecodeError(DecodeError, ValueError):
    """Truncated, bit-flipped or otherwise malformed wire bytes.

    Subclasses ValueError so ``except ValueError`` guards keep working;
    callers that want the typed contract catch CodecDecodeError (or
    DecodeError)."""


class ConfigError(LoroError, ValueError):
    """Invalid tuning value (rank spec, ruler spacing k, placement,
    device name, ...), raised at first use with the accepted values
    spelled out — never a silent fall-back to the default.

    Subclasses ValueError so ``except ValueError`` guards keep working.
    """

    def __init__(self, knob: str, got: object, accepted: str):
        self.knob = knob
        self.got = got
        self.accepted = accepted
        super().__init__(f"{knob}={got!r} invalid: accepted {accepted}")


class DeviceUnavailable(LoroError, RuntimeError):
    """An entry point was asked for a CUDA device on a machine without
    one.  The port never falls back to the CPU on its own: callers that
    want the CPU pass ``device="cpu"``."""
