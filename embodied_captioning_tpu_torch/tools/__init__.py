"""Real-checkpoint porting: torch state dicts to numpy parameter trees
(`convert_weights`), a plain-torch CoCa replica to hold them against
(`torch_replica`), and the turnkey port with its directory format
(`port`)."""
