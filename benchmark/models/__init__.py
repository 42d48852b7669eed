"""Model families: for each, how the harness makes a configuration's
weights from the seed, builds the port's estimator around them through its
public constructor, and asks the plain reference for the same model's
answers.  A configuration names its family in its ``model`` key."""
