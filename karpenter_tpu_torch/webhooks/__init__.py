"""The Provisioner admission webhook: defaulting and validation
(admission.py), its TLS identity (certs.py) and its HTTP server
(server.py)."""
