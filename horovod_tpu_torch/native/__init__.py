"""The port's copy of the stdlib half of ``horovod_tpu/native``: the
retry ladder (:mod:`.resilience`). The C++ store and ring it guards in
the reference are later slices; the serve wire (``serve/wire.py``)
classifies its socket faults through it already."""
