"""Cross-cutting helpers of the port: the daemons' shared-key auth and
TLS, and the two-kind plugin registry."""
