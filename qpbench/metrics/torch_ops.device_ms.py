"""Device ms per solve of everything the factor and chunk maps do not name:
torch's products (cuBLAS), the check's element-wise work, copies and the
auto-pad."""

LAYERS = ("factor.device_ms", "chunk.device_ms")


def read(run):
    t = run.trace
    if t is None:
        return None
    named = sum(t.ms_matching(run.kernels_of(m)) for m in LAYERS)
    rest = sum(t.device_ms.values()) - named
    return rest / t.solves if rest > 0 else None
