"""The paper's evaluation algorithms (§IV-A) on the port's R-like API:
summary, correlation, tall SVD, PCA, GLM (IRLS, dense or over a sparse
one-hot design), k-means, GMM, NMF and naive Bayes."""
from .summary import summary
from .correlation import correlation
from .svd import svd_tall
from .kmeans import kmeans
from .gmm import gmm
from .glm import glm, glm_predict, glm_iteration_plan
from .pca import pca
from .nmf import nmf
from .naive_bayes import naive_bayes, nb_predict

__all__ = ["summary", "correlation", "svd_tall", "kmeans", "gmm",
           "glm", "glm_predict", "glm_iteration_plan", "pca", "nmf",
           "naive_bayes", "nb_predict"]
