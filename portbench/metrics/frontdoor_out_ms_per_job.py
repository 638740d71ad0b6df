"""Host time of the traced job's way out, from the program's spans:
``engine.readback`` (the device-to-host copies once the card is done,
every lane's outputs), ``engine.results`` (every lane's
``ClusterResult``) and ``sweep.wrap`` (every lane's ``Result``), in ms
(``span_reader.wall_ms``: the job the digest read)."""
from portbench import span_reader


def read(run):
    return span_reader.wall_ms(
        run, ("engine.readback", "engine.results", "sweep.wrap"))
