"""Device memory: the state's tensor bytes (owners, geometry, contact
tables at their capacities), as DEMSolver.GetDeviceMemUsageDynamic
counts them, at the window's end."""


def read(rec):
    b = rec.get("state_bytes")
    return None if b is None else b / 2**30
