"""Error types."""


class LuminairError(Exception):
    """Base error for the proving stack."""


class EmptyTraceError(LuminairError):
    """A component trace table had no rows."""


class ProverError(LuminairError):
    pass


class KernelError(LuminairError):
    """A CUDA kernel could not be built, bound or launched, or was handed
    tensors it does not take."""


class SerializationError(LuminairError):
    pass
