"""Host time of the traced job's way in, from the program's spans: the
``sweep.plan`` spans (grouping, scenarios to configs, the cold-start
draws of every lane) and ``engine.load`` (host events, every lane's
initial pools, the upload, the block runner's lookup and load), in ms
(``span_reader.wall_ms``: the job the digest read)."""
from portbench import span_reader


def read(run):
    return span_reader.wall_ms(run, ("sweep.plan", "engine.load"))
