"""Exception types of tamp_tpu_torch (the port's copy of ``tamp_tpu.exceptions``)."""


class ExcessBitsError(Exception):
    """Provided data has more bits than the configured ``literal`` bits."""


class AbortedError(Exception):
    """A progress callback asked an in-flight native stream call to stop.

    The stream stays token-consistent across the abort, so the same call
    may be issued again to resume (:mod:`tamp_tpu_torch.stream`)."""


class OutOfBoundsError(ValueError):
    """A decoded window reference points outside the valid window."""
