"""Exception types of tamp_tpu_torch (the port's copy of ``tamp_tpu.exceptions``)."""


class ExcessBitsError(Exception):
    """Provided data has more bits than the configured ``literal`` bits."""


class OutOfBoundsError(ValueError):
    """A decoded window reference points outside the valid window."""
