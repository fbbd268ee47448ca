"""Data layer of the port: the ID vocabularies and the metadata/model
storage the deploy path reads. The event store arrives with the training
slice."""
