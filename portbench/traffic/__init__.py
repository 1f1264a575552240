"""Traffic: the job a pipeline runs over a sample's records. Each mix is a
data file here (``<traffic>.json``) that :mod:`portbench.traffic.generate`
reads beside the configuration."""
