"""Command-line tools of the port: the decode profiler
(`python -m butterfly_tpu_torch.tools.profile_decode`), the tensor
split's collective count (`python -m butterfly_tpu_torch.tools.tp_scaling`),
the port's static analyzer (`python -m butterfly_tpu_torch.tools.staticcheck`,
`butterfly lint`) and its mutation check
(`python -m butterfly_tpu_torch.tools.mutcheck`). The headline benchmark
is `python -m butterfly_tpu_torch.bench`."""
