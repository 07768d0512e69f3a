"""Generated CRD manifests (tools/gen_crds.py; reference pkg/apis/crds/)."""
