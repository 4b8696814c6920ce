"""Share of the MoE's picks dropped at capacity, over every dispatch of
the traced run's requests after its trace closed (the program's routing
output, counted by ``drivers.encode_requests.counting_moe``), in %."""


def read(run):
    m = run.get("moe")
    if not m or not m["picks"]:
        return None
    return 100.0 * m["dropped"] / m["picks"]
