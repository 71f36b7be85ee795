"""The port's bench and profiling tools: the bench CLI (`bench`, with its
device sections in `bench_device` and the real-socket serving run in
`bench_wire`), the per-block tick profile (`profile_tick`), the trace
fetcher (`trace`) and the timing helpers they and chip_smoke.py share
(`timing`). Each runs on the card unless the caller asks for the CPU."""
