"""Serving-side components of the port: the live asyncio HTTP front end for
the streaming label router (:mod:`repro_torch.serving.server`) and the
request-path straggler-mitigation model (:mod:`.scheduler`)."""
