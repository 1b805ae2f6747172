"""Selection core: contingency math, scores, criteria and the engines."""
